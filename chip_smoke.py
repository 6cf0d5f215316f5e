"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Drives the notary's committee audit through the port at its real size
(100 shards × 135 votes per period), through the entry point a notary
calls, `TorchSigBackend().bls_verify_committees`, on both of its paths
(and, after it, the notary's vote phase and its `--da-proofs poly`
phase at 100 and at 25 of the 100 shards, steps 10 and 11, and last the collation
replay of BASELINE config 4 and the fused period step of config 5,
steps 12 and 13, the notary service itself on its own chain, step
14, the sharding node with its CLI, step 15, that node sampled,
`--da-mode sampled`, step 16, the serving and resilience plane,
`--serving --soundness-rate --sigbackend failover-torch`, step 17, and
the cross-process topology, a chain process serving remote callers and a
devnet of OS processes, step 18, and the shard mesh, step 19):
the precomp path (with `pk_row_keys`, the notary's default: line tables
resident on the card) and the recompute path (without keys):

1. names the card and its power limit (nvidia-smi);
2. builds the CUDA kernels of `gethsharding_tpu_torch/csrc/` (timed) and
   prints each kernel's registers and spills (ptxas); the exact form's
   instances (`norm_kernel<W, 1>`, `tower_kernel<K, 1>`, and the probes of
   the exact carries and tail) again, failing the run on a stack frame or a spill;
3. makes a protocol-true period on the host: secret keys sk_j = j+1,
   votes (j+1)·H(m_s) and pubkeys (j+1)·G2 by repeated point addition,
   the committee order rotated per shard, and hostile rows with known
   answers (a forged vote, a missing signature whose pubkey is kept, an
   empty committee, two shards with swapped messages, and a committee
   whose votes and pubkeys cancel, so that its pairing is 1 and only the
   identity check rejects it);
4. holds the audit's four kernels (G1 and G2 committee sums, Miller
   product, final exponentiation) against their plain PyTorch versions
   on the card, on the tensors and shapes the audit gives them; the
   tower's two kernels (conv, normalize) on every combine and width of
   the path, with partial blocks, leading dims, a broadcast constant,
   negative and bound-edge limbs; the final exponentiation also on two
   synthetic programs, 64 products and 64 Frobenius maps (the kernel
   takes its program as an argument); the Miller product also on two
   synthetic op streams, 64 doublings and 64 additions cycling through the
   four candidates (the kernel takes its op stream as an argument); and
   the tower kernel (one launch per
   product: Fp, Fp2, Fp12 and line products) against each product's
   plain route on the same kinds of edge inputs: the limbs must be
   equal;
5. recompute path: sets every launch count to 0, runs the keyless audit
   once, and requires one launch of each audit kernel (normalizes are
   counted apart) and every verdict equal to the expected list; the same
   batch through the plain versions on the card must agree;
6. precomp path: counts from 0 again around a cold audit (tables built),
   around a warm one (the batch memo: the previous audit's key tuple) and
   around a warm one of the same committees in another shard order (the
   memo misses; every row's table comes from the LRU); all must give the
   expected verdicts, which equal the recompute path's; both warm audits
   must ship 0 G2 bytes and hit every non-empty row. The tower
   kernel's and normalize's inputs of the warm audit, one per shape, are
   held against the plain versions, and the batch's line tables and
   Miller product f must equal the plain route's limb for limb. The
   Miller loop must run every tower product as one tower launch: at most
   300 launches, no conv launch, and only the loop's three normalizes
   outside its products;
7. times both paths (cold median of 3 with hashing and, on the precomp
   path, table building included; warm median of 7, on the precomp path
   with and without the batch memo), the recompute
   audit's stages and its device kernels by name (torch.profiler), each
   kernel and its plain version (CUDA events, the
   launches queued before the first runs; the tower kernel at each of
   its shapes in the warm audit, the final exponentiation per product
   step and per Frobenius step and the Miller product per doubling and
   per addition step on the synthetic programs and streams beside their
   multiply-adds and bound, conv at the line product and normalize
   at its most frequent shape of the warm audit), their launches and summed
   device time per warm audit and the card's idle share (torch.profiler),
   and the Miller loop's host time against its summed kernel time;
8. aggregate votes: the period's votes summed on the host per shard,
   plus a signature at infinity and a pubkey at infinity (102 rows),
   through `TorchSigBackend().bls_verify_aggregates`, counted from 0: one
   Miller and one final-exponentiation launch and no committee sum or
   tower product, the expected verdicts, equal to the plain versions on
   the card; timed warm and cold, with its kernels under the profiler;
9. the exact 22-limb form, in a subprocess of this script with
   GETHSHARDING_TORCH_LIMB_FORM=exact (the form is read at import): the
   exact tower kernel (`tower_exact`) on every product kind, the 22-limb
   conv (`conv_exact`) on every combine and the exact normalize at widths
   22 to 52, on the same edge inputs as above, against their plain
   versions; the exact ladder's carries into 24, 23 and 22 limbs as its
   tail runs them (`norm.carry_probe`), its tail alone (`norm.tail_probe`) and `norm_exact`
   on `norm.carry_edge_rows` (whole-width
   carries and borrows, alternating 0/4095, negative values, carries off
   the top, ±2^28 and int32-edge limbs, seeded rows), against
   `limb.carry`, `norm.tail_plain` and the plain normalize; then,
   counted from 0, the
   100 × 135 recompute audit with
   keys and precomp off (`TorchSigBackend(precomp=False)`): the expected
   verdicts, one launch of each audit kernel, the exact normalize's
   launches on every input shape, and verdicts and Miller product f
   equal to the plain versions on the card; then the precomp audit
   (`TorchSigBackend()`, the notary's default), cold and warm: the
   expected verdicts, every tower product in `tower_exact`, 0 warm G2
   bytes, 22-limb tables of 46,464 B, the warm audit's tower and
   normalize inputs and the batch's line tables and f against the plain
   route on the card; the aggregate votes of step 8 in this form; and it
   times both audits (cold, warm, and for precomp a period of new
   messages with resident tables), the exact normalize (at its most
   frequent shape of the recompute audit and at each shape of the warm
   precomp audit), the exact tower at each of its shapes in the warm
   audit and the 22-limb conv at the line product; and the hostile and
   infinity rows of step 11 through `das_verify_multiproofs` at 22
   limbs, counted and held as there. The subprocess failing fails the
   run.
   Each kernel's bound counts the
   work the period needs (m - 1 additions for m votes, one pairing per
   non-empty row; the Fp2 products of the final exponentiation's Fp12
   products, of the G2 committee sum and of the Miller product (its walk,
   Fp12 square and sparse line products) at three schoolbooks each, as
   their kernels compute them, squares as full products; the Miller
   product's bound also at four, as earlier slices counted it; for conv,
   normalize and the tower kernel, the
   multiply-adds (625 per conv term, 484 in the exact form whatever the
   kernel widens to, 22 per folded limb) and bytes of the
   launch timed, each operand counted once as the kernel reads it,
   before any broadcast). The committee sums' share of their bound is
   printed beside the ceiling that the fixed tree puts on any kernel
   returning the plain version's limbs: the additions the period needs
   over those the padded tree makes;
10. the notary's vote phase at 100 shards: 100 proposer signatures from
   seeded keys (the port's own signer) and 9 hostile rows (r = 0, r = n,
   s = 0, s = n, an r with no curve point, recid 2 for the host
   fallback, v = 5, a 64-byte signature, a tampered digest), and 16
   sampled 4096-byte chunks per shard with depth-8 proofs (trees of 255
   leaves, the chunks' keys among seeded random leaves) and 7 hostile
   samples (a flipped chunk byte, a wrong sibling, a flipped index bit,
   a proof of 9 levels, a 4095-byte chunk, an index outside the proven
   tree, a wrong root). Counted from 0 around one
   `TorchSigBackend().ecrecover_addresses` and one `das_verify_samples`:
   one launch of `csrc/secp256k1.cu` and one of `csrc/das.cu` and no
   other kernel; addresses and verdicts equal to the host's scalar
   recovery and verifier row for row; each kernel equal to its plain
   version on the card at the path's tensors (tolerance 0), the
   recovery also at the exact form's 22 limbs; both kernels' ptxas
   registers and stack frame (0 bytes and no spills, or the smoke
   fails), and the sample kernel's keccak round counted in its SASS
   (`cuobjdump -sass`) beside the bound's 180 operations; each timed
   (CUDA events) beside its bound (the least multiply-adds the
   recovery needs: products mod p at 74 and squares at 46 on p's special
   form, the root's addition chain, no products for the inverses,
   counted per row from its ladder scalars, with the share of PR 10's
   fixed CIOS yardstick beside it; keccak-f permutations × 4,320 32-bit
   operations with three-input LOP3 logic, counted per valid sample from
   its proof depth, with the earlier count over every row beside it)
   and its plain version's one run, each also at one row (the txpool's
   call for the recovery), and both calls end to end (warm, median of 7,
   with their host marshal and bytes shipped; the samples' call split
   into marshal, upload with the kernel, and readback);
11. the notary's `--da-proofs poly` phase on the dev SRS (built first,
   timed), cut to 25 of the 100 shards (so that steps 16 and 18 fit the
   smoke's time): one row per shard, 16 indices without repeats
   over n = 255 chunk values (seeded 4096-byte chunks), committed and
   opened with the port's own `pcs.commit` / `open_multi`, and 12 more
   rows: a tampered eval, proof and commitment, an off-curve commitment,
   a short proof, a commitment coordinate >= p, duplicate indices, an
   empty set, an index outside the domain, an all-zero proof on a
   non-constant polynomial, and two rows True through the infinity
   path (a constant polynomial; a set opening every index of a 16-value
   domain). The port's scalar `verify_multiproofs` must give the known
   answers on those rows and two honest ones; then, counted from 0
   around one `TorchSigBackend().das_verify_multiproofs` over all 62
   rows: one `miller` and one `finalexp` launch (normalizes as glue) and
   no other kernel, the known verdicts, equal to the same planes through
   the plain versions on the card. Timed: the call, its host marshal
   split into G1 MSMs, G2 MSMs, the scalar pairings of the infinity rows
   and the rest, the device path with pull on the staged planes (median
   of 7), its kernels under the profiler and the idle share;
12. the collation replay (`ops/replay.py::replay_batch`) on config 4 as
   bench.py:556-584 defines it (64 transfers from one sender, the
   recipient as coinbase), on the same collation over a state of 4,096
   accounts (4,094 seeded genesis accounts beside the sender and the
   recipient), and on the hostile batch of tests/torch_replay_rows.py
   (every rejection class, the sender as coinbase, the zero-address row,
   a wrapping balance, v = 29, to = None, a value of 2^256, a nonce of
   2^31, overflowing gas costs). Counted from 0 around each call: one
   `ecrecover`, two `keccak_fixed` (addresses, roots) and one `replay`
   launch and no other kernel; statuses equal to the port's scalar
   replay, roots to `scalar_root_with_padding` and the canonical roots
   to the scalar trie; `csrc/keccak_fixed.cu` and `csrc/replay.cu` equal
   to their plain versions on the card at the path's tensors (tolerance
   0); the route of each keccak launch (a thread or a warp a message)
   and the replay's blocks a shard; both kernels' ptxas registers and
   stack (a stack frame or a spill fails the run); timed (CUDA events)
   beside their bounds, the larger of the rate bound (keccak-f
   permutations × 4,320 32-bit operations; the replay's bytes against
   its word operations) and the chain bound (the permutations or
   transactions in turn, each the function's own dependent path at the
   card's latencies and SM clock, measured by a probe; the design's
   trips beyond that path on a line of their own), and their plain
   versions: the root's µs a permutation, the replay at 4,096 accounts
   and at config 4; config 4 end to end (warm, median of 7) with its
   host marshal apart and its kernels under the profiler;
13. the fused period step of config 5 as bench.py:586-605 defines it
   (`parallel/stress.py::StressPipeline`, 1,024 shards, 2 votes and 1
   transaction a shard, a pool of 135), its host build (a process of its
   own started after the build, beside steps 1-12) timed on its own
   line, at quorum 90 (nothing elected) and quorum 2 (every shard
   elects). Counted from 0: three `keccak_fixed` and one launch each of
   `agg_g1`, `agg_g2`, `miller`, `finalexp`, `ecrecover` and `replay`,
   normalizes as glue; every attempt accepted, every aggregate and
   transaction valid, 2,048 votes, 0 or 1,024 elected; equal to the
   plain versions on the card (run once, at quorum 90: the quorum moves
   only the elected flags and their total); timed warm (median of 7)
   with its split by kernel and the idle share, `miller` and
   `finalexp` beside their operation bounds at the 1,024 rows;
14. the notary service (`actors/notary.py::Notary` with
   `TorchSigBackend()`) on config 5's pool: the port's
   `SimulatedMainchain(Config())` (100 shards, committee 135), 135 seeded
   members funded and registered with BLS pubkeys and proofs of
   possession (the build timed on its own line, the key derivation
   apart), the notary under test started as a service: the member the
   SMC samples for the most shards of period 1, its own shard the first,
   a header signed by another key on the second, a missing body on the
   third; 100 signed headers, the other 134 voting through their own
   `SMCClient`s where sampled; after period 1 closes one stored vote
   signature forged. Counted from 0 around the auditing head (the
   commit of period 2's first block): period 1 False with one mismatch
   on the forged shard, one `agg_g1`, one `finalexp`, one
   `keccak_fixed` (the vote-log replay on the card), tower launches, at
   most one `agg_g2` (the new committees' tables) and one `ecrecover`
   (the head's vote phase), normalizes as glue; a clean rerun of
   `audit_periods([1])` True (warm: no `agg_g2`), period 0 None,
   `verify_period_batch(1)` True with one `keccak_fixed`; the notary's
   one vote and its rejections. At quorum 90 (nothing elects) and
   quorum 1 (every voted shard elects, and the notary indexes its own
   shard's canonical header); the audit and the replay again through
   the plain versions on the card. Timed warm (median of 7): the
   auditing head end to end, `audit_periods([1])` split into
   `_collect_audit_rows`, the backend call and `_judge_period`,
   `verify_period_batch` alone, and the head's kernels under the
   profiler with the card's idle share;
15. the port's sharding node (`node/backend.py::ShardNode`) as
   `tests/torch_node_script.py` runs a devnet, at config 5's pool with
   step 14's member keys: one `SimulatedMainchain(Config(quorum_size=1,
   windback_depth=1))` and one shardp2p `Hub` shared by a notary node
   (`ShardNode(actor="notary", deposit=True)`, its pool index picked so
   that the SMC samples it in every period), 134 members voting from the
   script where sampled, proposer nodes on 4 shards whose txpools are fed
   33 signed transactions a period (32 applied, 1 rejected), an observer
   node on one of them, and the other 96 shards' headers proposed by the
   script; two periods sealed as the CLI's loop seals them, waiting on
   the services' counters. Counted from 0 around the run, by block: every
   kernel of the path launched (`agg_g1`, `tower`, `norm`, `finalexp`,
   `keccak_fixed`, `ecrecover`, `replay`); each auditing head one
   `agg_g1` and one `finalexp` with towers, normalizes, `keccak_fixed`
   and `ecrecover`; each replaying block one `replay`. The notary's
   bodies came over the hub (windback checks, bodies stored, each body
   it voted on in its shard DB), every canonical header in a node's DB
   is the SMC's approved record, the observer's roots equal the scalar
   replay's on the host, the journal and the mirror hold each period's
   votes and records, and no node recorded an error. The chunk and state
   roots of the run took the native route (`core/mpt.py`; counted). Then,
   with every node still up, a light node (`ShardNode(actor="light")`, no
   device) joins the hub: the observer's last collation proven by length,
   `availability_check(k=16)` True, four samples its bytes; a record whose
   body only the smoke holds and a forger on the hub answering every
   proof request with a proof over another body: no value returned,
   `proofs_rejected` raised; counted from 0 around the light node's calls,
   nothing launched. Timed: the heads,
   the replays, the notary's spans, every block, the last auditing head's
   kernels under the profiler with the idle share. Then the CLI in a
   process of its own (`python -m gethsharding_tpu_torch.cli sharding
   --actor notary --deposit --runtime 8 --blocktime 0.2`): exit 0, a
   sealed period, no service error;
16. the DAS plane on that node: step 15's devnet with every node
   `da_mode="sampled"` (16 samples, parity 0.5), 2 periods of 3 blocks,
   once with `--da-proofs merkle` and once with `poly`, and hostile
   shards with known answers on the notary's path, proposed and
   published by the script (44,416 B bodies, k = 11 of n = 17 chunks): in
   merkle every sample withheld, garbage chunks under the real
   commitment and a commitment signed by another key; in poly garbage
   chunks and one published merkle-only
   (`tests/torch_node_script.py::plan` places them on the shards of the
   member sampled for the most). The notary's votes are the SMC's records
   and its journal's, on its honest shards only; no body request leaves
   it; its verdict cache, `das/*` counters and errors are the known
   answers; counted from 0 around the run, by block, each head launches
   the batched DAS calls the layout gives (`sampled_expected`: one call
   for its fresh candidates, one for each uncached windback period; one
   `das_samples`, or one `miller` and one `finalexp`, a call), and every
   launch inside those calls equals its plain version on the card on the
   tensors it was given; each layout makes a windback call. Then a light
   node sampled (a DAS service with no store) runs `das_check` on a
   proposer's shard (True) and on the withheld one (False), launching
   nothing. Timed: the
   heads (whole and without the hostile candidates' fetch waits), the
   DAS spans and calls, the kernels on a head's tensors, a head's idle
   share under the profiler. Beside the devnets, the CLI, `sharding
   --actor notary --deposit --da-mode sampled --da-proofs poly --runtime
   4 --blocktime 0.2`: exit 0, a sealed period, no service error;
17. the serving and resilience plane (`serving_phase`), five phases:
   (1) coalescing: 8 threads split step 3's period (keyed, hostile rows
   included), 32 threads recover one of step 10's signatures each, 32
   threads split its samples, each group through
   `ServingSigBackend(TorchSigBackend())` at the default `ServingConfig`:
   every request's result is the direct call's in its row order, fewer
   dispatches than requests, counted from 0 each committee dispatch one
   `agg_g1` and one `finalexp` (towers, normalizes), each recovery
   dispatch one `ecrecover`, each sample dispatch one `das_samples`, all
   on the dispatch thread on the default stream; requests, dispatches,
   rows a dispatch, per-request latency (median, p99) beside the direct
   call's, the coalesced committees' idle share under the profiler;
   (2) `SpotCheckSigBackend` over the tier at rate 1 (2 rows a check) on
   every op, a clean card: checks, no mismatch, no invariant violation,
   the host ms of a checked row; (3) `failover-serving-torch` with the
   spot-checker under `backend.bls_verify_committees:mode=corrupt` for 3
   dispatches of 2 rows: the breaker trips within `dispatches_to_detect`'s
   budget, the open call is served by the host, the half-open probe
   recomputes on the card and re-closes, the timeline printed, trips,
   faults and fallbacks exactly the schedule's; (4) a 4 s chaos hang of
   the dispatch thread under a 1.5 s watchdog: `DeadlineExceeded`, the
   next batches served on the card by a fresh thread, the stale thread's
   late call equal too; (5) step 15's devnet cut to 1 period with every
   node `failover-torch` over the spot-checker (rate 1, one row) over
   `serving=True`: the notary's votes the SMC's records, the audit's,
   recovery's and the proposers' txpool kernels launched on the dispatch
   threads, primary calls equal to the serving requests and the
   launches to their dispatches, breakers closed, 0 fallbacks, 0
   mismatches, no node error; then `sharding --actor notary --deposit
   --serving --soundness-rate 0.05 --sigbackend failover-torch --runtime 8
   --blocktime 0.2`: exit 0, a sealed period, no service error. Timed,
   phase by phase;
18. the cross-process topology (`topology_phase`): (1) `python -m
   gethsharding_tpu_torch.rpc.chain_server --sigbackend torch --quorum 1`
   as a child process; 8 client threads, each on its own `RPCClient`,
   send step 3's period as 8 keyed `shard_verifyCommittees` requests
   (hostile rows included), 32 single `shard_ecrecover` calls on step
   10's signatures, step 10's samples as 8 `shard_dasVerify` requests,
   and one `shard_verifyPeriodBatch` of a period with a vote, a warm-up
   round first: every reply equal to the smoke's direct in-process call
   row for row, fewer dispatches than requests, and by the chain
   process's exit line (stderr) launches of `agg_g1`, `tower`, `norm`,
   `finalexp`, `ecrecover`, `das_samples` and `keccak_fixed`; timed per
   request over the wire (median, p99) beside step 17's in-process
   request and the direct call; (2) `python -m gethsharding_tpu_torch.cli
   devnet --notaries 1 --proposers 2 --observers 1 --lights 1 --quorum 1
   --shardcount 2 --sigbackend torch --blocktime 0.2` with a datadir,
   dialed from here: a sealed period in which the notary's vote on each
   proposed shard is the SMC's approved record, then the notary
   SIGKILLed, respawned by the devnet with the same account (its
   keystore), no second deposit, a vote again; at exit the notary
   child's launches (`agg_g1`, `finalexp`, `tower`, `norm`,
   `ecrecover`) and heads from its log, the chain child's vote-log
   replay (`keccak_fixed`), the observer's canonical headers, the light
   child's exit line with no launch, no child error;
19. the shard mesh (`mesh_phase`) over the distinct cards where there
   are two or more, else 4 slots of `cuda:0` (printed which): (1) step
   3's period through `TorchSigBackend(device=slots)`, keyed cold and
   warm and unkeyed: the verdicts of one device's backend, one
   reduction a step (`last_mesh`), every slot holding its verdicts, the
   vote total their sum, each slot's audit kernels launched (counted
   from `launch_counts`), the slots' line-table caches sharing no
   tensor; both warm audits timed beside one device; (2)
   `CommitteePeriodPipeline` on the period plus one shard (101, uneven)
   over the 1-D mesh and a 2 × 2 ("dcn", "ici") mesh: every plane and
   total equal to one device, one reduction per mesh axis; (3) config
   5's mesh form on step 13's inputs (not built again) at 1,024 and
   1,023 shards: every plane and total equal to one device's step bit
   for bit, one reduction, timed beside it; (4) the dry run twin
   (`parallel/dryrun.py`) on the slots, and `sharding --mesh-devices N`
   with N one above the visible cards, which must exit non-zero with
   `requested N devices, only N-1 visible`.

Beside steps 9-12, in a process of its own (`--roots-phase`), the trie
family's roots on the host: the compiled root (`csrc/mpt.c`, `cc`) loaded
and equal to the Python trie on the empty list, 1, 63, 64 and 127-300
items, duplicate keys, values of 55-64 B and the replay rows' state
tables, lists past its caps refused; `chunk_root` timed on 64 KiB by both
routes and on 1 MiB by the native one.

Prints a JSON line of per-kernel numbers, the card's name and power
limit, and last `{"ok": true, "device": {...}}`. Exits non-zero, with no
result line, where there is no CUDA card, the host hash did not load its
compiled keccak or the trie root its compiled builder, or any check
fails. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import functools
import hashlib
import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate (data sheet)
# int32 multiply-adds: 64 per clock per SM on compute capability 9.0 (CUDA
# programming guide's throughput table) × 132 SMs × 1.98 GHz boost clock
INT32_MAD_PER_S = 132 * 64 * 1.98e9
MAX_LIMB = int(2 ** 30.7) - 1   # the accumulators' limb bound

SHARDS = 100
COMMITTEE = 135
HOSTILE = (3, 17, 42, 60, 61, 80)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_period(bls, seed: int):
    """One audit period with known verdicts, and one key per committee."""
    msgs = [b"period-%d/shard-%d/header" % (seed, s) for s in range(SHARDS)]
    pks, acc = [], None
    for _ in range(COMMITTEE):
        acc = bls.g2_add(acc, bls.G2_GEN)
        pks.append(acc)                         # (j+1)·G2
    sig_rows, pk_rows = [], []
    for s, m in enumerate(msgs):
        h = bls.hash_to_g1(m)
        mults, acc = [], None
        for _ in range(COMMITTEE):
            acc = bls.g1_add(acc, h)
            mults.append(acc)                   # (j+1)·H(m_s)
        order = [(j + s) % COMMITTEE for j in range(COMMITTEE)]
        sig_rows.append([mults[j] for j in order])
        pk_rows.append([pks[j] for j in order])
    sig_rows[3][7] = bls.g1_add(sig_rows[3][7], bls.G1_GEN)   # forged vote
    sig_rows[17][5] = None          # missing signature, pubkey kept
    sig_rows[42], pk_rows[42] = [], []                        # empty committee
    msgs[60], msgs[61] = msgs[61], msgs[60]                   # swapped messages
    vote, pk = sig_rows[80][0], pk_rows[80][0]                # cancelling
    sig_rows[80] = [vote, bls.g1_neg(vote)]
    pk_rows[80] = [pk, bls.g2_neg(pk)]
    want = [s not in HOSTILE for s in range(SHARDS)]
    keys = [("committee", seed, s) for s in range(SHARDS)]
    return msgs, sig_rows, pk_rows, keys, want


def cuda_ms(fn, reps: int, queued: bool = True) -> float:
    """Mean milliseconds per call over `reps` warm calls, CUDA events.
    `queued`: the card first sleeps ~10 ms, so that the host has queued
    every launch before the first runs, and a kernel shorter than its
    launch's host cost is timed on the card, back to back, not at the
    host's pace (the plain versions are timed at the host's pace)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_times(fn):
    """Run `fn` once under torch.profiler: (kernel device milliseconds
    summed by kernel name, from the card's own trace; host wall
    milliseconds of the run, synchronized). Empty where the profiler
    saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = collections.Counter()
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            by_name[evt.name] += evt.time_range.elapsed_us() / 1e3
    return by_name, wall_ms


KERNEL_LABELS = ("tower_kernel", "conv_kernel", "norm_kernel", "agg_kernel",
                 "miller_kernel", "finalexp_kernel", "keccak_fixed_kernel",
                 "replay_kernel", "ecrecover_kernel")


def kernel_label(name: str) -> str:
    """The port's kernel a device event belongs to, or "glue" (PyTorch's
    own kernels: elementwise ops, copies)."""
    return next((k for k in KERNEL_LABELS if k in name), "glue")


def kernel_split(by_name) -> dict:
    """Device ms by the port's kernels (conv, norm, the audit kernels)
    and PyTorch's own (glue: elementwise ops, copies)."""
    split = collections.Counter()
    for name, ms in by_name.items():
        split[kernel_label(name)] += ms
    return split


def traced_calls(fn, runs: int, per_call: dict):
    """`fn` run `runs` times in one torch.profiler session: (device ms
    per call by label, launches the trace kept by label). A trace can
    lose a launch, so each of the port's kernels in `per_call` (label ->
    launches per call) is the mean of its kept launches times its
    launches per call; glue is its total over `runs`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total, kept = collections.Counter(), collections.Counter()
    for evt in prof.events():
        if evt.device_type == DeviceType.CUDA:
            label = kernel_label(evt.name)
            total[label] += evt.time_range.elapsed_us() / 1e3
            kept[label] += 1
    return ({label: total[label] / kept[label] * per_call[label]
             if label in per_call else total[label] / runs
             for label in total}, kept)


def host_ms(fn, reps: int) -> float:
    """Median host milliseconds of `reps` warm calls; `fn` synchronizes."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def count_multiply_adds(mk, fn, karatsuba: bool = False) -> int:
    """int32 multiply-adds of one call of the plain version `fn`, which
    does the kernel's arithmetic step for step: 625 per 25×25 schoolbook
    convolution, 22 per folded limb of every normalize. With `karatsuba`,
    as the final-exponentiation, G2 committee-sum and Miller kernels do
    them: three schoolbooks per Fp2 product (of an Fp12 product, of a
    sparse line product and of `_fp2_mul`) where the plain version has
    four."""
    count = [0]
    conv, norm = mk._conv, mk._normalize
    mul, fp2_mul, mul_line = mk._fp12_mul, mk._fp2_mul, mk._fp12_mul_line
    sq = mk.KNL * mk.KNL

    def conv_counted(u, v):
        out = conv(u, v)
        count[0] += out[..., 0].numel() * sq
        return out

    def norm_counted(z, C):
        count[0] += z[..., 0].numel() * (z.shape[-1] + 2 - mk.KFOLD_BASE) \
            * mk.KFOLD_BASE
        return norm(z, C)

    def mul_counted(x, y, C):   # 36 Fp2 products per Fp12 product
        count[0] -= x[..., 0, 0, 0].numel() * 36 * sq
        return mul(x, y, C)

    def fp2_mul_counted(x, y, C):
        lead = torch.broadcast_shapes(x.shape, y.shape)[:-2]
        count[0] -= math.prod(lead) * sq
        return fp2_mul(x, y, C)

    def mul_line_counted(f, A, B, Cc, C):   # 18 Fp2 products
        count[0] -= f[..., 0, 0, 0].numel() * 18 * sq
        return mul_line(f, A, B, Cc, C)

    mk._conv, mk._normalize = conv_counted, norm_counted
    if karatsuba:
        mk._fp12_mul, mk._fp2_mul = mul_counted, fp2_mul_counted
        mk._fp12_mul_line = mul_line_counted
    try:
        fn()
    finally:
        mk._conv, mk._normalize = conv, norm
        mk._fp12_mul, mk._fp2_mul = mul, fp2_mul
        mk._fp12_mul_line = mul_line
    return count[0]


def ptxas_report(log: str) -> list:
    """(kernel, registers, stack frame bytes, spill stores, spill loads)
    of every entry function in nvcc's -Xptxas -v log, names demangled to
    `name<args>` (an int argument, then a NormForm one: `norm_kernel<25,
    1>` is the exact form's instance)."""
    rows, name, spill = [], "?", (0, 0, 0)
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '_ZN2gs(\d+)(\w+)'",
                          line)
        if entry:
            size, rest = int(entry.group(1)), entry.group(2)
            name = rest[:size]
            targs = re.match(r"ILi(\d+)E(?:L\w*?NormFormE(\d+)E)?",
                             rest[size:])
            if targs:
                name += "<" + ", ".join(g for g in targs.groups() if g) + ">"
        found = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        if found:
            spill = tuple(int(g) for g in found.groups())
        used = re.search(r"Used (\d+) registers", line)
        if used:
            rows.append((name, int(used.group(1))) + spill)
    return rows


def kernel_ptxas(source: str, kernel: str, log: str):
    """(registers, stack frame, spill stores, spill loads) of `kernel` from
    the build's ptxas log, or, where the library was already built (no
    log), from `source` compiled alone."""
    from gethsharding_tpu_torch.ops import _build

    rows = [r[1:] for r in ptxas_report(log) if r[0] == kernel]
    if not rows:
        obj = _build.BUILD_DIR / f"{kernel}.ptxas.o"
        out = subprocess.run(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-c",
             str(_build.SRC_DIR / source), "-o", str(obj)],
            capture_output=True, text=True, check=True, timeout=600)
        obj.unlink(missing_ok=True)
        rows = [r[1:] for r in ptxas_report(out.stdout + out.stderr)
                if r[0] == kernel]
    if not rows:
        fail(f"ptxas reported nothing for {kernel}")
    return rows[0]


def exact_ptxas(log: str) -> list:
    """The ptxas rows of the exact form's instances (norm_kernel<W, 1>,
    tower_kernel<K, 1>) and of the exact carry's and tail's probes, from
    the build's log or, where the library was already built, from
    norm.cu and tower.cu compiled alone (both nvcc processes at once)."""
    from gethsharding_tpu_torch.ops import _build

    pick = lambda rows: [r for r in rows if r[0].endswith(", 1>")
                         or r[0].startswith(("norm_carry_kernel",
                                             "norm_tail_kernel"))]
    rows = pick(ptxas_report(log))
    if not rows:
        procs = [subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-c",
             str(_build.SRC_DIR / src), "-o",
             str(_build.BUILD_DIR / f"{src}.ptxas.o")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src in ("norm.cu", "tower.cu")]
        for src, proc in zip(("norm.cu", "tower.cu"), procs):
            out, _ = proc.communicate(timeout=600)
            (_build.BUILD_DIR / f"{src}.ptxas.o").unlink(missing_ok=True)
            rows += pick(ptxas_report(out))
    if len([r for r in rows if r[0].endswith(", 1>")]) != 8:
        fail(f"ptxas reported {len(rows)} rows for the exact instances")
    return rows


def source_constants(source: str, prefix: str) -> dict:
    """The `constexpr int <prefix>... = <number>;` constants of a source
    in csrc/, by name."""
    from gethsharding_tpu_torch.ops import _build

    src = (_build.SRC_DIR / source).read_text()
    return {k: int(v) for k, v in re.findall(
        rf"constexpr int ({prefix}\w+) = (\d+);", src)}


def kernel_sass(source: str) -> str:
    """`cuobjdump -sass` of `source` compiled alone for the card."""
    from gethsharding_tpu_torch.ops import _build

    nvcc = _build.nvcc_path()
    cubin = _build.BUILD_DIR / f"{os.path.splitext(source)[0]}.sass.cubin"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([nvcc, *_build.NVCC_FLAGS, "-cubin",
                    str(_build.SRC_DIR / source), "-o", str(cubin)],
                   capture_output=True, text=True, check=True, timeout=600)
    out = subprocess.run(
        [os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass",
         str(cubin)], capture_output=True, text=True, check=True,
        timeout=120)
    cubin.unlink(missing_ok=True)
    return out.stdout


def sass_opcode(text: str) -> str:
    """The opcode of one SASS instruction, without predicate or
    modifiers (`@!P0 LOP3.LUT R1, ...` -> `LOP3`)."""
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0].split(".")[0] if words else ""


def sass_inner_loops(sass: str, kernel: str) -> list:
    """Opcode counts of each innermost loop of `kernel` in `cuobjdump
    -sass` output: the instructions from a backward branch's target to
    the branch."""
    instrs, labels, inside = [], {}, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        if not inside:
            continue
        label = re.match(r"\s*\.(L_x_\d+):", line)
        if label:
            labels[label.group(1)] = len(instrs)
            continue
        found = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if found:
            instrs.append((int(found.group(1), 16), found.group(2)))
    at = {addr: i for i, (addr, _) in enumerate(instrs)}
    loops = []
    for i, (_, text) in enumerate(instrs):
        if sass_opcode(text) != "BRA":
            continue
        named = re.search(r"\(\.(L_x_\d+)\)", text)
        address = re.search(r"0x([0-9a-f]+)", text)
        j = (labels.get(named.group(1)) if named else
             at.get(int(address.group(1), 16)) if address else None)
        if j is not None and j <= i:
            loops.append((j, i))
    inner = [(j, i) for j, i in loops
             if not any(j <= j2 and i2 <= i and (j2, i2) != (j, i)
                        for j2, i2 in loops)]
    return [collections.Counter(sass_opcode(instrs[k][1])
                                for k in range(j, i + 1)) for j, i in inner]


def max_abs_err(got, want) -> int:
    if isinstance(got, tuple):
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    return int((got.long() - want.long()).abs().max().item())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(macs: int, moved: int) -> dict:
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = macs / INT32_MAD_PER_S * 1e3
    return {"multiply_adds": macs, "bytes": moved,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


# Synthetic final-exponentiation programs (rows (op, a, b, d) over the
# kernel's 14 registers, result in register 13; 0 = mul, 2 = frob_b): 64
# products (the first a square) and 64 Frobenius maps (n = 1, 2, 3 in
# turn), each step's result feeding the next. The kernel takes its program
# as an argument, so they time one kind of step on its own.
STEP_PROGRAMS = {
    "product": [(0, 0, 0, 13)] + [(0, 0, 13, 13)] * 63,
    "Frobenius": [(2, 0, 1, 13)] + [(2, 13, 1 + i % 3, 13)
                                    for i in range(1, 64)],
}


TOWER_COVER = ("every product kind (Fp, Fp2 mul and sqr, Fp12, line), 112 "
               "and 113 rows, leading dims, broadcast constants and middle "
               "dims, gapped rows, all-4095, all-4160, all--1 and all-zero "
               "limbs")
CONV_COVER = ("every combine of the path, 112 to 672 rows, a partial block, "
              "leading dims, a broadcast constant, 4160 against -1 limbs")


# Synthetic Miller op streams (0 = DBL, 1-4 = ADD with that candidate;
# step i takes line i of the generator-line table): 64 doublings and 64
# additions cycling through the four candidates. The kernel takes its
# stream as an argument, so they time one kind of step on its own.
MILLER_STEPS = {
    "DBL": [0] * 64,
    "ADD": [1 + i % 4 for i in range(64)],
}


class TowerLaunches:
    """While open, records the shapes at which the tower kernel and
    normalize launch: per shape, its launches (read from the kernel's own
    counter, so a call that launches nothing is not one) and its first
    input, which `check_samples` holds against the plain version
    afterwards. The tower kernel's shapes are its operands' own, before
    they broadcast."""

    def __init__(self, tower, norm, plan_names: dict):
        self.tower, self.norm, self.plan_names = tower, norm, plan_names
        self.counts = collections.Counter()   # shape key -> launches
        self.samples = {}                     # shape key -> inputs

    def __enter__(self):
        self._kernels = (self.tower.tower_kernel, self.norm.normalize_kernel)
        tower_kernel, normalize_kernel = self._kernels
        self.tower.tower_kernel = lambda plan, u, v: self._record(
            ("tower", self.plan_names[id(plan)], tuple(u.shape),
             tuple(v.shape)), self.tower.KERNEL, tower_kernel, plan, u, v)
        self.norm.normalize_kernel = lambda arith, z: self._record(
            ("norm", tuple(z.shape)), self.norm.KERNEL, normalize_kernel,
            arith, z)
        return self

    def __exit__(self, *exc):
        self.tower.tower_kernel, self.norm.normalize_kernel = self._kernels

    def _record(self, key, kernel, fn, *args):
        before = kernel.launches
        out = fn(*args)
        if kernel.launches > before:
            if key not in self.samples:
                self.samples[key] = tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args)
            self.counts[key] += 1
        return out


def lead_rows(*shapes) -> int:
    """Batch rows of (..., G, A, 25) operands whose leading dims
    broadcast."""
    return math.prod(torch.broadcast_shapes(*(s[:-3] for s in shapes)))


def conv_work(key, comb) -> dict:
    """Multiply-adds and bytes of one conv launch at `key`'s operand
    shapes: every nonzero combine term is one NL×NL convolution per row
    of the broadcast lead (625 in the wide form, 484 in the exact form,
    whatever the kernel widens to); each operand is read once, in its own
    shape (a broadcast operand is not copied out to the rows)."""
    from gethsharding_tpu_torch.ops import conv, limb

    _, _, xs, ys = key
    n = lead_rows(xs, ys)
    nterms = int(np.count_nonzero(comb))
    out_ints = n * comb.shape[3] * comb.shape[4] * conv.NCOLS
    plan_ints = conv.plane_plan(comb).size
    return bound(n * nterms * limb.NLIMBS ** 2,
                 4 * (math.prod(xs) + math.prod(ys) + out_ints + plan_ints))


def fold_work(width: int) -> int:
    """Multiply-adds of one normalize of a `width`-limb row: 22 per
    folded limb (width + 3 - 22 of them)."""
    return max(0, width + 3 - 22) * 22


def norm_work(key) -> dict:
    """Multiply-adds and bytes of one normalize launch at `key`'s shape."""
    n, w = key[1]
    return bound(n * fold_work(w), 4 * (n * w + n * 25 + 33 * 22 + 22))


def tower_work(key, plan) -> dict:
    """Multiply-adds and bytes of one tower launch at `key`'s operand
    shapes, per row of the broadcast lead, in the ambient limb form: NL²
    per conv term of each output k (625 wide, 484 exact: the schoolbooks
    the work needs, not the 25-limb slots the exact form is staged in),
    and the folds of its normalizes (xi·v's 12 rows once per row for the
    Fp12 kinds, at the xi width; every (k, c, g) plane at the plan's
    accumulator width; the group merges at NL), with the exact ladder's
    three later folds. Each operand is read once in its own shape, the
    output written once, the pack read once."""
    from gethsharding_tpu_torch.ops import limb, tower

    _, _, us, vs = key
    n = lead_rows(us, vs)
    _, _, _, C, Gr, K = tower.SHAPES[plan.kind]
    ladder = 6 * 22 if limb.LIMB_FORM == "exact" else 0
    norm_at = lambda w: fold_work(w) + ladder
    per_row = (K * plan.nterms * limb.NLIMBS ** 2
               + K * C * Gr * norm_at(plan.acc_w)
               + (Gr - 1) * K * C * norm_at(limb.NLIMBS))
    if K > 1:
        per_row += 12 * norm_at(tower.XI_W)
    out_ints = n * math.prod(plan.out_block)
    return bound(n * per_row, 4 * (math.prod(us) + math.prod(vs) + out_ints
                                   + plan.pack.size))


def check_samples(samples, tower, norm, route) -> dict:
    """Each recorded input through the kernel and the plain version."""
    errs = {"tower": 0, "norm": 0}
    for key, args in samples.items():
        if key[0] == "tower":
            got = tower.tower_kernel(*args)
            with route.plain_versions():
                want = args[0].plain(*args[1:])
        else:
            got = norm.normalize_kernel(*args)
            want = norm.normalize_plain(*args)
        errs[key[0]] = max(errs[key[0]], max_abs_err(got, want))
    return errs


def edge_rows(gen, dev, n: int, w: int) -> torch.Tensor:
    """n accumulators of w limbs with value >= 0: random limbs within
    ±2^30.7, three rows at the bound edge (every limb ±(2^30.7 - 1), the
    top one positive) and a row of -1 limbs over a top limb of 1."""
    z = torch.randint(-MAX_LIMB, MAX_LIMB + 1, (n, w), generator=gen,
                      device=dev, dtype=torch.int32)
    z[:, -1] = z[:, -1].abs().clamp(min=1 << 29)   # value >= 0
    z[:3] = torch.where(z[:3] < 0, -MAX_LIMB, MAX_LIMB)
    z[:3, -1] = MAX_LIMB
    z[3] = -1
    z[3, -1] = 1
    return z


def check_tower_edges(bn, tower, conv, norm, route, plans: dict,
                      combs: dict, dev, widths) -> dict:
    """Conv on every combine of the path at 112 rows, at the stacked
    Fp12 shape, with a partial last block, extra leading dims and a
    broadcast constant; normalize at each of `widths` with negative and
    bound-edge limbs; the tower kernel on every product kind with the
    same leads and broadcasts, an operand with gaps between its rows, and
    all-4095, all-4160, all--1 and all-zero limbs. Operands have the
    ambient form's limbs. Returns the largest |kernel - plain| of each."""
    nl = bn.NLIMBS
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    canon = lambda shape: torch.randint(0, 1 << 12, shape + (nl,),
                                        generator=gen, device=dev,
                                        dtype=torch.int32)
    full = lambda shape, v: torch.full(shape, v, dtype=torch.int32,
                                       device=dev)
    errs = {"tower": 0, "conv": 0, "norm": 0}
    for comb in combs.values():
        G, A, B = comb.shape[:3]
        for lead in ((112,), (113,), (112 * 6,), (4, 29)):
            x, y = canon(lead + (G, A)), canon(lead + (G, B))
            errs["conv"] = max(errs["conv"], max_abs_err(
                conv.pair_conv_combine(x, y, comb),
                conv.pair_conv_combine_plain(x, y, comb)))
        pairs = (   # broadcast constants; x along the six outputs of an
                    # Fp12 product; x a view with gaps between its rows;
                    # 4160 against -1 limbs
            (canon((112, G, A)), canon((G, B))),
            (canon((G, A)), canon((112, G, B))),
            (canon((112, 1, G, A)), canon((112, 6, G, B))),
            (canon((113, 2, G, A))[:, 1], canon((113, G, B))),
            (full((112, G, A, nl), 4160), full((112, G, B, nl), -1)))
        for a, b in pairs:
            errs["conv"] = max(errs["conv"], max_abs_err(
                conv.pair_conv_combine(a, b, comb),
                conv.pair_conv_combine_plain(a, b, comb)))
    for plan in plans.values():
        ub, vb = plan.u_block, plan.v_block
        cases = [(canon(lead + ub[:2]), canon(lead + vb[:2]))
                 for lead in ((112,), (113,), (4, 29))]
        cases += [
            (canon((112,) + ub[:2]), canon(vb[:2])),
            (canon(ub[:2]), canon((112,) + vb[:2])),
            (canon((112, 1) + ub[:2]), canon((112, 6) + vb[:2])),
            (canon((113, 2) + ub[:2])[:, 1], canon((113,) + vb[:2])),
            (full((112,) + ub, 4095), full((112,) + vb, 4095)),
            (full((112,) + ub, 4160), full((112,) + vb, 4160)),
            (full((112,) + ub, -1), canon((112,) + vb[:2])),
            (full((112,) + ub, 0), canon((112,) + vb[:2]))]
        for u, v in cases:
            if plan is plans["fp2_sqr"]:
                v = u
            got = tower.tower_kernel(plan, u, v)
            with route.plain_versions():
                want = plan.plain(u, v)
            errs["tower"] = max(errs["tower"], max_abs_err(got, want))
    for w in widths:
        z = edge_rows(gen, dev, 1000, w)
        errs["norm"] = max(errs["norm"], max_abs_err(
            bn.FP.normalize(z.reshape(10, 100, w)).reshape(1000, nl),
            norm.normalize_plain(bn.FP, z)))
    return errs


def norm_exact_work(key) -> dict:
    """Multiply-adds and bytes of one exact-form normalize launch at
    `key`'s shape: 22 per folded limb, in the first fold (width + 3 - 22
    limbs) and the ladder's folds of 3, 2 and 1 limbs; each row read once
    and written once at 22 limbs, the fold rows once."""
    n, w = key[1]
    return bound(n * (fold_work(w) + 6 * 22),
                 4 * (n * w + n * 22 + 33 * 22))


def audit_steps(bn, mk, hx, hy, sx, sy, sm, gx, gy, gm, hok):
    """`bls_aggregate_verify_committee_batch` step by step: (its Miller
    product f, its verdicts)."""
    sig = mk.aggregate_proj(sx, sy, sm, fp2=False)
    pk = mk.aggregate_proj(gx, gy, gm, fp2=True)
    inf = bn.FP.is_zero(sig[2]) | bn.fp2_is_zero(pk[2])
    f = mk.miller_f(sig, hx, hy, pk)
    return f, mk.finalexp_is_one(f) & hok & ~inf


def aggregate_votes(bls, msgs, sig_rows, pk_rows, want):
    """The period's votes aggregated on the host, one (message, aggregate
    signature, aggregate pubkey) per shard (None where a sum is the
    identity: the empty and the cancelling committees), and two more
    hostile rows: a signature at infinity with a real pubkey, and a real
    signature with a pubkey at infinity. Returns them with the expected
    verdicts: the period's, then False twice."""
    sum_row = lambda add, row: functools.reduce(
        lambda acc, pt: acc if pt is None else add(acc, pt), row, None)
    agg_sigs = [sum_row(bls.g1_add, row) for row in sig_rows]
    agg_pks = [sum_row(bls.g2_add, row) for row in pk_rows]
    return (list(msgs) + [msgs[0], msgs[1]],
            agg_sigs + [None, agg_sigs[1]], agg_pks + [agg_pks[0], None],
            list(want) + [False, False])


def aggregates_phase(label, bls, bn, route, build, backend, votes,
                     card) -> dict:
    """`bls_verify_aggregates` on the period's host-aggregated votes:
    counted from 0 around one call (one Miller and one final-exponentiation
    launch, no committee sum, no tower product), its verdicts against the
    expected list and against the plain versions on the card, then timed
    warm (hashes cached, median of 7) and cold (messages hashed, median of
    3) with its device kernels under the profiler."""
    msgs, agg_sigs, agg_pks, want = votes
    for k in build.KERNELS.values():
        k.launches = 0
    got = backend.bls_verify_aggregates(msgs, agg_sigs, agg_pks)
    launches = {n: c for n, c in build.launch_counts().items() if c}
    print(f"{label}aggregate votes ({len(msgs)} rows): launches {launches}",
          flush=True)
    if got != want:
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        fail(f"{label}aggregate verdicts differ from the expected list at "
             f"{bad}")
    if launches.get("miller") != 1 or launches.get("finalexp") != 1 \
            or any(launches.get(n) for n in ("agg_g1", "agg_g2", "tower",
                                             "tower_exact")):
        fail(f"{label}bls_verify_aggregates did not run one Miller and one "
             f"final-exponentiation launch alone: {launches}")
    hashes = [bls.hash_to_g1(bytes(m)) for m in msgs]
    (hx, hy, hok), (sx, sy, sok), (px, py, pok) = (
        bn.g1_to_limbs(hashes), bn.g1_to_limbs(agg_sigs),
        bn.g2_to_limbs(agg_pks))
    args = [torch.as_tensor(a, device="cuda")
            for a in (hx, hy, sx, sy, px, py, hok & sok & pok)]
    with route.plain_versions():
        plain = bn.bls_verify_aggregate_batch(*args)
    if plain.cpu().tolist() != got:
        fail(f"{label}the plain versions on the card give other aggregate "
             f"verdicts")
    call = lambda: backend.bls_verify_aggregates(msgs, agg_sigs, agg_pks)
    warm_ms = host_ms(call, 7)
    cold_s = []
    for _ in range(3):
        bls.hash_to_g1.cache_clear()
        t0 = time.perf_counter()
        call()
        cold_s.append(time.perf_counter() - t0)
    cold_ms = statistics.median(cold_s) * 1e3
    split = kernel_split(device_times(call)[0])
    busy = sum(split.values())
    print(f"time {label}aggregate votes (bls_verify_aggregates, {len(msgs)} "
          f"rows, {sum(got)} true): warm median {warm_ms:.2f} ms of 7, "
          f"{len(msgs) / warm_ms * 1e3:.0f} votes/s, host marshal "
          f"{backend.last_timing['marshal_s'] * 1e3:.2f} ms; cold (messages "
          f"hashed) median {cold_ms:.2f} ms of 3; device kernels "
          f"{busy:.2f} ms under the profiler "
          f"({', '.join(f'{k} {v:.3f}' for k, v in split.items())}), idle "
          f"share {1 - busy / warm_ms:.3f} [{card}]", flush=True)
    return {"warm_ms": warm_ms, "cold_ms": cold_ms, "kernels_ms": busy}


# the vote phase: a proposer signature per shard, VOTE_SAMPLES sampled
# chunks per shard (`--da-samples` default, node/cli.py:126), each a leaf
# of a commitment tree of TREE_LEAVES leaves (MAX_TOTAL_CHUNKS: depth 8)
VOTE_SAMPLES = 16
TREE_LEAVES = 255


def _no_curve_point(P: int) -> int:
    """The smallest x >= 5 with x^3 + 7 not a square mod P."""
    x = 5
    while pow((x ** 3 + 7) % P, (P - 1) // 2, P) == 1:
        x += 1
    return x


@functools.lru_cache(maxsize=None)
def vote_period(ecdsa, das, keccak256, seed: int):
    """One period's vote-phase inputs with known answers. Recovery: a
    proposer signature per shard from seeded keys (the port's own
    signer), then r = 0, r = n, s = 0, s = n, an r with no curve point,
    recid 2 (the host fallback), v = 5, a 64-byte signature and a tampered
    digest; the expected address of each row from the host's scalar
    recovery. Samples: VOTE_SAMPLES full 4096-byte chunks per shard, each
    at its index of a tree whose other leaves are seeded random 32-byte
    values (the verifier cannot tell them from chunk keys), with its
    depth-8 proof; then a flipped chunk byte, a wrong sibling, a flipped
    index bit, a proof of 9 levels, a 4095-byte chunk, an index outside
    the proven tree and a wrong root; the expected verdicts from the
    scalar verifier."""
    rng = np.random.default_rng(seed)
    digests, sigs65, privs = [], [], []
    for s in range(SHARDS):
        priv = int.from_bytes(keccak256(b"vote/%d/proposer/%d" % (seed, s)),
                              "big") % ecdsa.N or 1
        digest = keccak256(b"vote/%d/header/%d" % (seed, s))
        digests.append(digest)
        sigs65.append(ecdsa.sign(digest, priv).to_bytes65())
        privs.append(priv)
    sig0 = ecdsa.Signature.from_bytes65(sigs65[0])
    d0 = digests[0]
    hostile = [
        (d0, ecdsa.Signature(0, sig0.s, sig0.v).to_bytes65()),
        (d0, ecdsa.Signature(ecdsa.N, sig0.s, sig0.v).to_bytes65()),
        (d0, ecdsa.Signature(sig0.r, 0, sig0.v).to_bytes65()),
        (d0, ecdsa.Signature(sig0.r, ecdsa.N, sig0.v).to_bytes65()),
        (d0, ecdsa.Signature(_no_curve_point(ecdsa.P), sig0.s,
                             sig0.v).to_bytes65()),
        (d0, sigs65[0][:64] + bytes([2])),
        (d0, sigs65[0][:64] + bytes([5])),
        (d0, sigs65[0][:64]),
        (keccak256(b"vote/%d/tampered" % seed), sigs65[0]),
    ]
    digests += [d for d, _ in hostile]
    sigs65 += [sg for _, sg in hostile]

    def host(digest, sig):
        try:
            return ecdsa.ecrecover_address(
                digest, ecdsa.Signature.from_bytes65(sig))
        except (ValueError, AssertionError):
            return None

    want_addr = [host(d, sg) for d, sg in zip(digests, sigs65)]
    if want_addr[:SHARDS] != [ecdsa.priv_to_address(k) for k in privs] \
            or want_addr[SHARDS:-1] != [None] * (len(hostile) - 1) \
            or want_addr[-1] in (None, want_addr[0]):
        fail("the host's recovery of the vote period is not as built")

    chunks, indices, proofs, roots = [], [], [], []
    for s in range(SHARDS):
        picked = sorted(int(i) for i in rng.choice(TREE_LEAVES, VOTE_SAMPLES,
                                                   replace=False))
        data = rng.integers(0, 256, (VOTE_SAMPLES, 4096), dtype=np.uint8)
        leaves = [rng.bytes(32) for _ in range(TREE_LEAVES)]
        mine = [data[k].tobytes() for k in range(VOTE_SAMPLES)]
        for k, i in enumerate(picked):
            leaves[i] = das.chunk_leaf(mine[k])
        levels = das.merkle_levels(leaves)
        for k, i in enumerate(picked):
            chunks.append(mine[k])
            indices.append(i)
            proofs.append(das.merkle_proof(levels, i))
            roots.append(levels[-1][0])
    c, i, p, root = chunks[0], indices[0], proofs[0], roots[0]
    flip = lambda b, at: b[:at] + bytes([b[at] ^ 1]) + b[at + 1:]
    bad = [(flip(c, 100), i, p, root),
           (c, i, p[:3] + (flip(p[3], 0),) + p[4:], root),
           (c, i ^ 1, p, root),
           (c, i, p + (b"\x00" * 32,), root),
           (c[:-1], i, p, root),
           (c, i + 256, p, root),
           (c, i, p, flip(root, 31))]
    for row in bad:
        for col, v in zip((chunks, indices, proofs, roots), row):
            col.append(v)
    want_ok = das.verify_samples(chunks, indices, proofs, roots)
    if want_ok != [True] * (SHARDS * VOTE_SAMPLES) + [False] * len(bad):
        fail("the scalar verdicts of the vote period are not as built")
    return (digests, sigs65, want_addr), (chunks, indices, proofs, roots,
                                          want_ok)


def once_ms(fn):
    """(result, milliseconds) of one call, CUDA events, synchronized."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


# Dependent latencies of one warp on the card, for the chain bounds of
# step 12: the cycles a 32-bit LOP3, a funnel shift (SHF) and an IADD3 take
# when each feeds the next; a shared-memory round trip as the warp route
# of keccak_fixed.cu and the replay's chain make it (a lane stores,
# `__syncwarp()`, another lane's load feeds the next store; two buffers
# in turn, so one sync a trip); and the SM clock (a spin of clock64()
# cycles against CUDA events).
LATENCY_PROBE = r"""
extern "C" __global__ void gs_latency_probe(unsigned* io, long long* clk,
                                            int iters, long long spin) {
  __shared__ volatile unsigned sm[2][32];
  const unsigned lane = threadIdx.x & 31;
  unsigned a = io[lane], b = io[32], c = io[33];
  long long t[5];
  t[0] = clock64();
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j)
      asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;"
                   : "+r"(a) : "r"(b), "r"(c));
  t[1] = clock64();
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j)
      asm volatile("shf.l.wrap.b32 %0, %0, %1, 7;" : "+r"(a) : "r"(b));
  t[2] = clock64();
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j)
      asm volatile("add.u32 %0, %0, %1;" : "+r"(a) : "r"(b));
  t[3] = clock64();
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      sm[j & 1][lane] = a;
      __syncwarp();
      a = sm[j & 1][(lane + 1) & 31];
    }
  t[4] = clock64();
  const long long s0 = clock64();
  while (clock64() - s0 < spin) {
  }
  io[lane] = a;
  if (threadIdx.x == 0)
    for (int k = 0; k < 4; ++k) clk[k] = t[k + 1] - t[k];
}
"""


@functools.lru_cache(maxsize=None)
def chain_latencies() -> dict:
    """Cycles of a dependent LOP3, SHF, IADD3 and shared-memory round
    trip in one warp, and the SM clock in Hz, measured on the card
    (LATENCY_PROBE, built by nvcc into _build/latency/)."""
    import ctypes

    from gethsharding_tpu_torch.ops import _build

    out = _build.BUILD_DIR / "latency"
    out.mkdir(parents=True, exist_ok=True)
    (out / "probe.cu").write_text(LATENCY_PROBE + r"""
extern "C" int gs_latency_run(unsigned* io, long long* clk, int iters,
                              long long spin, void* stream) {
  gs_latency_probe<<<1, 32, 0, (cudaStream_t)stream>>>(io, clk, iters,
                                                       spin);
  return (int)cudaGetLastError();
}
""")
    subprocess.run([_build.nvcc_path(), *_build.ARCH_FLAGS, "-O3",
                    "-shared", "-Xcompiler", "-fPIC", str(out / "probe.cu"),
                    "-o", str(out / "libprobe.so")], check=True,
                   capture_output=True, text=True, timeout=300)
    lib = ctypes.CDLL(str(out / "libprobe.so"))
    lib.gs_latency_run.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_longlong,
                                   ctypes.c_void_p]
    io = torch.arange(34, dtype=torch.int32, device="cuda") + 3
    clk = torch.zeros(4, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(iters, spin):
        if lib.gs_latency_run(io.data_ptr(), clk.data_ptr(), iters, spin,
                              stream):
            fail("the latency probe did not launch")

    iters = 4096
    run(iters, 0)                      # warm
    run(iters, 0)
    per = (clk.cpu().double() / (16 * iters)).tolist()
    spin = 40_000_000
    _, ms = once_ms(lambda: run(0, spin))
    return {"lop3": per[0], "shf": per[1], "iadd3": per[2],
            "smem_round_trip": per[3], "sm_hz": spin / (ms * 1e-3)}


def vote_phase(card: str, seed: int) -> list:
    """Step 10: the notary's vote phase at 100 shards. Counted from 0
    around one `ecrecover_addresses` (the period's proposer signatures)
    and one `das_verify_samples` (samples × shards): one launch of each
    kernel and no other, the addresses and verdicts equal to the host's
    scalar ones; then each kernel against its plain version on the card
    at the main path's tensors (tolerance 0), timed beside its bound and
    its plain version, and both calls end to end. Returns the two
    kernels' entries of the kernels line."""
    from gethsharding_tpu_torch.crypto import secp256k1 as ecdsa
    from gethsharding_tpu_torch.crypto.keccak import keccak256
    from gethsharding_tpu_torch.das import proofs as das
    from gethsharding_tpu_torch.ops import _build, limb, route
    from gethsharding_tpu_torch.ops import secp256k1 as secp
    from gethsharding_tpu_torch.sigbackend import marshal
    from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend

    t0 = time.perf_counter()
    (digests, sigs65, want_addr), (chunks, indices, proofs, roots,
                                   want_ok) = vote_period(ecdsa, das,
                                                          keccak256, seed)
    n_sig, n_smp = len(digests), len(chunks)
    print(f"vote period: {n_sig} proposer signatures ({SHARDS} shards and "
          f"{n_sig - SHARDS} hostile rows), {n_smp} samples ({SHARDS} shards "
          f"× {VOTE_SAMPLES}, trees of {TREE_LEAVES} leaves, and "
          f"{n_smp - SHARDS * VOTE_SAMPLES} hostile rows), made in "
          f"{time.perf_counter() - t0:.1f} s on the host", flush=True)

    backend = TorchSigBackend()
    for k in _build.KERNELS.values():
        k.launches = 0
    got_addr = backend.ecrecover_addresses(digests, sigs65)
    got_ok = backend.das_verify_samples(chunks, indices, proofs, roots)
    launches = {name: c for name, c in _build.launch_counts().items() if c}
    print(f"vote phase: launches {launches}", flush=True)
    if launches != {"ecrecover": 1, "das_samples": 1}:
        fail(f"the vote phase did not run one launch of each of its two "
             f"kernels alone: {launches}")
    if got_addr != want_addr:
        bad = [i for i, (g, w) in enumerate(zip(got_addr, want_addr))
               if g != w]
        fail(f"recovered addresses differ from the host's at rows {bad}")
    if got_ok != want_ok:
        bad = [i for i, (g, w) in enumerate(zip(got_ok, want_ok)) if g != w]
        fail(f"sample verdicts differ from the scalar verifier's at {bad}")
    print(f"vote phase: {sum(a is not None for a in got_addr)} of {n_sig} "
          f"addresses recovered, equal to the host's row for row; "
          f"{sum(got_ok)} of {n_smp} samples verified, equal to the scalar "
          f"verifier's", flush=True)

    dev = torch.device("cuda")
    planes, _ = marshal.ecrecover_host_planes(digests, sigs65)
    rec = [torch.as_tensor(a, device=dev) for a in planes]
    rec_kernel = lambda: secp.ecrecover_kernel(*rec)
    got = rec_kernel()
    with route.plain_versions():
        want, rec_plain_ms = once_ms(lambda: secp.ecrecover_plain(*rec))
    rec_err = max(max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
    print(f"kernel ecrecover: max |kernel - plain| over qx, qy = {rec_err} "
          f"(tolerance 0), ok equal: {torch.equal(got[2], want[2])} "
          f"({rec[0].shape[0]} rows)", flush=True)
    if rec_err or not torch.equal(got[2], want[2]):
        fail("ecrecover disagrees with its plain version")
    nl22 = 22   # the exact form's limbs: every value here is below 2^256
    short = [t[:, :nl22].contiguous() for t in rec[:3]] + rec[3:]
    out22 = [torch.empty_like(short[0]), torch.empty_like(short[0]),
             torch.empty_like(rec[4])]
    secp.KERNEL.launch(*map(_build.ptr, short), short[0].shape[0], nl22,
                       *map(_build.ptr, out22))
    err22 = max(max_abs_err(out22[0], want[0][:, :nl22]),
                max_abs_err(out22[1], want[1][:, :nl22]))
    print(f"kernel ecrecover at {nl22} limbs: max |kernel - plain| = "
          f"{err22} (tolerance 0), ok equal: "
          f"{torch.equal(out22[2], want[2])}", flush=True)
    if err22 or not torch.equal(out22[2], want[2]):
        fail("ecrecover at 22 limbs disagrees with its plain version")
    regs, stack, stores, loads = kernel_ptxas("secp256k1.cu",
                                              "ecrecover_kernel",
                                              _build.build_log)
    print(f"kernel ecrecover: ptxas {regs} registers, stack frame {stack} "
          f"B, spill stores {stores} B, spill loads {loads} B [{card}]",
          flush=True)
    if stack or stores or loads:
        fail("ecrecover_kernel keeps operands in local memory")
    layout = source_constants("secp256k1.cu", "SECP_")
    layout["SECP_ROWS"] = layout["SECP_WARP_ROWS"] * layout["SECP_WARPS"]
    ints = [limb.limbs_to_int(a[:n_sig]) for a in planes[:3]]
    scalars = [secp.ladder_scalars(int(e), int(r), int(s))
               for e, r, s in zip(*ints)]
    squares, products = (sum(c) for c in zip(
        *(secp.least_products(*u) for u in scalars)))
    row_bytes = 5 * limb.NLIMBS * 4 + 4 + 1 + 1
    rec_bound = bound(sum(secp.least_multiply_adds(*u) for u in scalars),
                      n_sig * row_bytes)
    yard = bound(sum(secp.kernel_multiply_adds(*u) for u in scalars),
                 n_sig * row_bytes)
    rec_ms = cuda_ms(rec_kernel, 10)
    one = [t[:1].contiguous() for t in rec]
    rec1_ms = cuda_ms(lambda: secp.ecrecover_kernel(*one), 10)
    print(f"kernel ecrecover: the fixed yardstick (CIOS products, Fermat "
          f"inverses; over-counts the function's work) "
          f"{yard['multiply_adds']} multiply-adds, {yard['bound_ms']:.6f} "
          f"ms, {yard['bound_ms'] / rec_ms:.2%} of it; at one row (bucket "
          f"1, the txpool's call) {rec1_ms:.4f} ms per launch [{card}]",
          flush=True)

    st = das.marshal_samples(chunks, indices, proofs, roots,
                             marshal.bucket_size(n_smp))
    smp = [torch.as_tensor(st[k], device=dev) for k in das.PLANES]
    das_kernel = lambda: das.verify_planes_kernel(*smp)
    got = das_kernel()
    with route.plain_versions():
        want, das_plain_ms = once_ms(lambda: das.verify_planes(*smp))
    das_err = int((got != want).sum().item())
    print(f"kernel das_samples: rows where kernel != plain = {das_err} "
          f"(tolerance 0; {smp[0].shape[0]} rows)", flush=True)
    if das_err:
        fail("das_samples disagrees with its plain version")
    regs, stack, stores, loads = kernel_ptxas("das.cu", "das_kernel",
                                              _build.build_log)
    print(f"kernel das_samples: ptxas {regs} registers, stack frame {stack} "
          f"B, spill stores {stores} B, spill loads {loads} B [{card}]",
          flush=True)
    if stack or stores or loads:
        fail("das_kernel keeps its sponges in local memory")
    das_layout = source_constants("das.cu", "DAS_")
    unroll = das_layout["DAS_ROUND_UNROLL"]
    try:
        rounds = [c for c in sass_inner_loops(kernel_sass("das.cu"),
                                              "das_kernel")
                  if c["LOP3"] >= 100]
    except (OSError, subprocess.SubprocessError) as exc:
        print(f"kernel das_samples: SASS not read ({exc})", flush=True)
        rounds = None
    for c in rounds or ():
        per_round = sum(c.values()) / unroll
        print(f"kernel das_samples: a keccak round in SASS (a loop of "
              f"{unroll} rounds / {unroll}): {per_round:g} instructions "
              f"against the bound's {das.ROUND_OPS}: " + ", ".join(
                  f"{op} {n / unroll:g}" for op, n in c.most_common()),
              flush=True)
    if rounds == []:
        print("kernel das_samples: no keccak round loop found in the SASS",
              flush=True)
    depths = st["levels"].sum(axis=1)
    ok_rows = st["valid"]
    perms = sum(das.sample_permutations(int(d)) for d in depths[ok_rows])
    old_perms = sum(das.sample_permutations(int(d)) for d in depths[:n_smp])
    smp_row_bytes = sum(int(st[k][0].nbytes) for k in das.PLANES[:-1])
    # valid rows' planes, and the valid flag and verdict of every row
    moved = int(ok_rows.sum()) * smp_row_bytes + 2 * smp[0].shape[0]
    das_bound = bound(perms * das.PERMUTATION_OPS, moved)
    old_bound = bound(old_perms * das.PERMUTATION_OPS,
                      n_smp * (smp_row_bytes + 2))
    das_ms = cuda_ms(das_kernel, 10)
    one = [t[:1].contiguous() for t in smp]
    das1_ms = cuda_ms(lambda: das.verify_planes_kernel(*one), 10)
    print(f"kernel das_samples: the bound over the {int(ok_rows.sum())} "
          f"valid rows, {perms} permutations, {das_bound['bound_ms']:.6f} "
          f"ms; the earlier count over all {n_smp} rows, {old_perms} "
          f"permutations, {old_bound['bound_ms']:.6f} ms "
          f"({old_bound['bound_ms'] / das_ms:.1%} of it); at one row "
          f"{das1_ms:.4f} ms per launch [{card}]", flush=True)
    # the launch's rows a block (das.cu `das_block_rows`)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    block_rows = min(das_layout["DAS_BLOCK_SAMPLES"],
                     max(1, -(-smp[0].shape[0] // sms)))

    for name, ms, plain_ms, r, unit in (
            ("ecrecover", rec_ms, rec_plain_ms, rec_bound,
             f"the least work: {squares} squares × "
             f"{secp.LEAST_SQUARE_MULTIPLY_ADDS} and {products} other "
             f"products × {secp.LEAST_PRODUCT_MULTIPLY_ADDS} multiply-adds "
             f"mod p, {secp.LEAST_N_PRODUCTS * n_sig} × "
             f"{secp.PRODUCT_MULTIPLY_ADDS} mod n, over {n_sig} rows; "
             f"{layout['SECP_LANES']} lanes a row, "
             f"{-(-rec[0].shape[0] // layout['SECP_ROWS'])} blocks of "
             f"{layout['SECP_ROWS']} rows on 132 SMs"),
            ("das_samples", das_ms, das_plain_ms, das_bound,
             f"{perms} keccak-f permutations × {das.PERMUTATION_OPS} 32-bit "
             f"operations over the {int(ok_rows.sum())} valid samples; "
             f"{block_rows} samples a block of {das_layout['DAS_THREADS']} "
             f"threads, {-(-smp[0].shape[0] // block_rows)} blocks on {sms} "
             f"SMs")):
        print(f"time {name}: kernel {ms:.4f} ms per launch, plain "
              f"{plain_ms:.1f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: {unit}; {r['bytes']} B), "
              f"{r['bound_ms'] / ms:.1%} of its bound, 1 launch per call "
              f"[{card}]", flush=True)

    call_rec = lambda: backend.ecrecover_addresses(digests, sigs65)
    e2e_rec = host_ms(call_rec, 7)
    rec_marshal = backend.last_timing["marshal_s"] * 1e3
    parts = ("marshal_s", "device_s", "readback_s")
    das_split = []

    def call_das():
        backend.das_verify_samples(chunks, indices, proofs, roots)
        das_split.append([backend.last_timing[k] * 1e3 for k in parts])
    e2e_das = host_ms(call_das, 7)
    split = dict(zip(parts, np.median(das_split[1:], axis=0)))
    das_marshal = split["marshal_s"]
    wire = backend.last_wire["wire_bytes"]
    rec_wire = sum(int(a.nbytes) for a in planes)
    print(f"time vote phase end to end (warm, median of 7): "
          f"ecrecover_addresses {n_sig} rows {e2e_rec:.2f} ms (host marshal "
          f"{rec_marshal:.2f} ms, {rec_wire} B shipped; its kernel's share "
          f"{rec_ms / e2e_rec:.3f}); das_verify_samples {n_smp} rows "
          f"{e2e_das:.2f} ms (host marshal {das_marshal:.2f} ms, {wire} B "
          f"shipped; its kernel's share {das_ms / e2e_das:.3f}) [{card}]",
          flush=True)
    print(f"time das_verify_samples, medians of those 7 calls: marshal "
          f"{das_marshal:.3f} ms, upload and kernel {split['device_s']:.3f} "
          f"ms, readback {split['readback_s']:.3f} ms [{card}]", flush=True)
    entry = lambda name, kernel, err, ms, plain_ms, r: {
        "name": name, "route": "cuda", "source": kernel.source,
        "replaces": kernel.replaces, "launches": launches[name],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None}
    return [entry("ecrecover", secp.KERNEL, rec_err, rec_ms, rec_plain_ms,
                  rec_bound),
            entry("das_samples", das.KERNEL, das_err, das_ms, das_plain_ms,
                  das_bound)]


# the multiproof phase: one row per shard, VOTE_SAMPLES indices sampled
# without repeats from a domain of TREE_LEAVES (MAX_TOTAL_CHUNKS) chunk
# values, each a 4096-byte chunk's keccak mod N; half the shards, so that
# step 16 fits the smoke's time (a row's host MSMs take ~0.5 s)
POLY_ROWS = SHARDS // 4
POLY_CHUNK = 4096


class MultiproofSplit:
    """While open, times the multiproof marshal's G1 MSMs, G2 MSMs and
    scalar pairings (the rows with a point at infinity are settled on
    the host) by wrapping `pcs.g1_msm`, `pcs.g2_msm` and
    `pcs.pairing_check`, and keeps the planes that the backend passes to
    `bls_verify_aggregate_batch`."""

    def __init__(self, pcs, bn):
        self.pcs, self.bn = pcs, bn
        self.seconds = collections.Counter()
        self.calls = collections.Counter()
        self.planes = None

    def __enter__(self):
        pcs, bn = self.pcs, self.bn
        self._saved = (pcs.g1_msm, pcs.g2_msm, pcs.pairing_check,
                       bn.bls_verify_aggregate_batch)
        pcs.g1_msm = self._timed("g1_msm", pcs.g1_msm)
        pcs.g2_msm = self._timed("g2_msm", pcs.g2_msm)
        pcs.pairing_check = self._timed("pairing_check", pcs.pairing_check)
        batch = bn.bls_verify_aggregate_batch

        def keep(*args):
            self.planes = [a.clone() for a in args]
            return batch(*args)
        bn.bls_verify_aggregate_batch = keep
        return self

    def __exit__(self, *exc):
        (self.pcs.g1_msm, self.pcs.g2_msm, self.pcs.pairing_check,
         self.bn.bls_verify_aggregate_batch) = self._saved

    def _timed(self, name, fn):
        def run(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                self.seconds[name] += time.perf_counter() - t0
                self.calls[name] += 1
        return run


def poly_values(pcs, rng, n: int) -> list:
    """n chunk values of seeded random 4096-byte chunks."""
    data = rng.integers(0, 256, (n, POLY_CHUNK), dtype=np.uint8)
    return [pcs.chunk_value(row.tobytes()) for row in data]


def poly_opened(pcs, values, indices) -> tuple:
    """An honest multiproof row: (commitment, indices, evals, proof, n)."""
    proof, evals = pcs.open_multi(values, indices)
    return (pcs.g1_to_bytes(pcs.commit(values)), list(indices), evals,
            pcs.g1_to_bytes(proof), len(values))


def poly_hostile(pcs, bls, seed: int):
    """The multiproof phase's hostile rows, from their own honest row over
    TREE_LEAVES values: a tampered eval, proof and commitment, an
    off-curve commitment, a short proof, a commitment coordinate >= p,
    duplicate indices, an empty set, an index outside the domain, an
    all-zero (infinity) proof on a non-constant polynomial; then two rows
    True through the infinity path: a constant polynomial (π at infinity)
    and a set that opens every index of a 16-value domain (A and π at
    infinity). Returns (names, rows, expected verdicts)."""
    rng = np.random.default_rng([seed, 1])
    idx = sorted(int(i) for i in rng.choice(TREE_LEAVES, VOTE_SAMPLES,
                                            replace=False))
    c, idx, ev, pf, n = poly_opened(pcs, poly_values(pcs, rng, TREE_LEAVES),
                                    idx)
    c_pt, p_pt = pcs.g1_from_bytes(c), pcs.g1_from_bytes(pf)
    x = int.from_bytes(c[:32], "big")
    table = [
        ("tampered eval", (c, idx, [ev[0], (ev[1] + 1) % pcs.N] + ev[2:],
                           pf, n)),
        ("tampered proof",
         (c, idx, ev, pcs.g1_to_bytes(bls.g1_add(p_pt, bls.G1_GEN)), n)),
        ("tampered commitment",
         (pcs.g1_to_bytes(bls.g1_add(c_pt, bls.G1_GEN)), idx, ev, pf, n)),
        ("off-curve commitment", (b"\x07" * 64, idx, ev, pf, n)),
        ("short proof", (c, idx, ev, pf[:32], n)),
        ("coordinate >= p",
         ((x + bls.P).to_bytes(32, "big") + c[32:], idx, ev, pf, n)),
        ("duplicate indices", (c, [idx[0]] + idx[:-1], ev, pf, n)),
        ("empty set", (c, [], [], pf, n)),
        ("index outside the domain", (c, idx[:-1] + [n], ev, pf, n)),
        ("zero proof", (c, idx, ev, b"\x00" * 64, n)),
        ("constant polynomial",
         poly_opened(pcs, [ev[0]] * TREE_LEAVES, idx)),
        ("every index", poly_opened(pcs, poly_values(pcs, rng, 16),
                                    range(16))),
    ]
    names = [name for name, _ in table]
    return names, [row for _, row in table], [False] * 10 + [True, True]


def poly_period(pcs, seed: int, rows: int) -> list:
    """One honest multiproof row per shard: TREE_LEAVES chunk values,
    VOTE_SAMPLES indices without repeats, from a seeded generator."""
    rng = np.random.default_rng([seed, 0])
    out = []
    for _ in range(rows):
        values = poly_values(pcs, rng, TREE_LEAVES)
        idx = sorted(int(i) for i in rng.choice(TREE_LEAVES, VOTE_SAMPLES,
                                                replace=False))
        out.append(poly_opened(pcs, values, idx))
    return out


def multiproof_check(label, pcs, bn, route, build, backend, rows, want,
                     split=None):
    """Counted from 0 around one `das_verify_multiproofs` call: one Miller
    and one final-exponentiation launch (normalizes between them are
    glue) and no other kernel, the expected verdicts, and the same planes
    through the plain versions on the card. Returns (verdicts, launches,
    the call's host seconds, the planes on the card)."""
    cols = [list(col) for col in zip(*rows)]
    for k in build.KERNELS.values():
        k.launches = 0
    split = split or MultiproofSplit(pcs, bn)
    with split:
        t0 = time.perf_counter()
        got = backend.das_verify_multiproofs(*cols)
        call_s = time.perf_counter() - t0
    launches = {n: c for n, c in build.launch_counts().items() if c}
    timing = backend.last_timing["launches"]
    print(f"{label}multiproofs ({len(rows)} rows, bucket "
          f"{backend.last_wire['bucket']}): launches {launches}", flush=True)
    if timing.get("miller") != 1 or timing.get("finalexp") != 1 or any(
            c for n, c in launches.items()
            if n not in ("miller", "finalexp", "norm", "norm_exact")):
        fail(f"{label}das_verify_multiproofs did not run one Miller and one "
             f"final-exponentiation launch alone: {launches}")
    if got != want:
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        fail(f"{label}multiproof verdicts differ from the known answers at "
             f"rows {bad}")
    with route.plain_versions():
        plain = bn.bls_verify_aggregate_batch(*split.planes)
    if plain.cpu().tolist()[:len(rows)] != want:
        fail(f"{label}the plain versions on the card give other multiproof "
             f"verdicts")
    print(f"{label}multiproofs: {sum(got)} of {len(rows)} rows verified, "
          f"equal to the known answers and to the plain versions on the "
          f"card", flush=True)
    return got, launches, call_s, split.planes


def multiproof_phase(card: str, seed: int) -> None:
    """Step 11: the notary's `--da-proofs poly` phase at 100 shards
    through `TorchSigBackend().das_verify_multiproofs`, on the dev SRS."""
    from gethsharding_tpu_torch.crypto import bn256 as bls
    from gethsharding_tpu_torch.das import pcs, poly_proofs
    from gethsharding_tpu_torch.ops import _build, route
    from gethsharding_tpu_torch.ops import bn256 as bn
    from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend

    t0 = time.perf_counter()
    srs = pcs.dev_srs()
    srs_s = time.perf_counter() - t0
    print(f"multiproof SRS: {len(srs.g1_powers)} G1 and {len(srs.g2_powers)} "
          f"G2 powers of τ, built in {srs_s:.2f} s on the host (once per "
          f"process)", flush=True)
    t0 = time.perf_counter()
    honest = poly_period(pcs, seed, POLY_ROWS)
    names, hostile, hostile_want = poly_hostile(pcs, bls, seed)
    rows = honest + hostile
    want = [True] * POLY_ROWS + hostile_want
    print(f"multiproof period: {len(rows)} rows ({POLY_ROWS} shards of "
          f"{SHARDS}, cut: {VOTE_SAMPLES} indices over n = "
          f"{TREE_LEAVES} each; {len(hostile)} hostile and infinity rows), "
          f"made in {time.perf_counter() - t0:.1f} s on the host",
          flush=True)
    # the port's scalar verdicts on the hostile rows and two honest ones
    t0 = time.perf_counter()
    picked = hostile + honest[:2]
    scalar = poly_proofs.verify_multiproofs(
        *(list(col) for col in zip(*picked)))
    if scalar != hostile_want + [True, True]:
        bad = [n for n, g, w in zip(names + ["honest 0", "honest 1"], scalar,
                                    hostile_want + [True, True]) if g != w]
        fail(f"the scalar multiproof verdicts are not as built: {bad}")
    print(f"multiproofs: the port's scalar verify_multiproofs agrees on the "
          f"{len(hostile)} hostile and infinity rows and 2 honest rows "
          f"({time.perf_counter() - t0:.1f} s on the host)", flush=True)

    backend = TorchSigBackend()
    split = MultiproofSplit(pcs, bn)
    got, launches, call_s, planes = multiproof_check(
        "", pcs, bn, route, _build, backend, rows, want, split)
    marshal_s = backend.last_timing["marshal_s"]
    g1_s, g2_s = split.seconds["g1_msm"], split.seconds["g2_msm"]
    pair_s = split.seconds["pairing_check"]
    device = lambda: bn.bls_verify_aggregate_batch(*planes).cpu()
    device_ms = host_ms(device, 7)
    # the same with the planes' upload, as the backend runs it
    host = [p.cpu().numpy() for p in planes]
    upload = lambda: bn.bls_verify_aggregate_batch(
        *(torch.as_tensor(a, device="cuda") for a in host)).cpu()
    upload_ms = host_ms(upload, 7)
    # its kernels over 5 calls in one trace: traces of one call lost its
    # Miller launch in a whole smoke run
    runs = 5
    split_ms, kept = traced_calls(upload, runs, {
        "miller_kernel": launches["miller"],
        "finalexp_kernel": launches["finalexp"],
        "norm_kernel": launches.get("norm", 0)})
    lost = [k for k in ("miller_kernel", "finalexp_kernel")
            if k not in split_ms]
    if lost:
        print(f"multiproofs: the trace of {runs} calls kept no launch of "
              f"{lost}: their device time is not measured here", flush=True)
    busy = sum(split_ms.values())
    print(f"time multiproofs (das_verify_multiproofs, {len(rows)} rows, "
          f"bucket {backend.last_wire['bucket']}, {sum(got)} true): one call "
          f"{call_s * 1e3:.1f} ms; SRS built once {srs_s * 1e3:.1f} ms; host "
          f"marshal {marshal_s * 1e3:.1f} ms = G1 MSMs {g1_s * 1e3:.1f} ms "
          f"({split.calls['g1_msm']} calls) + G2 MSMs {g2_s * 1e3:.1f} ms "
          f"({split.calls['g2_msm']} calls) + scalar pairings of the "
          f"infinity rows {pair_s * 1e3:.1f} ms ({split.calls['pairing_check']}"
          f" calls) + the rest {(marshal_s - g1_s - g2_s - pair_s) * 1e3:.1f} "
          f"ms; {backend.last_wire['wire_bytes']} B shipped; device path "
          f"with pull on staged planes median {device_ms:.2f} ms of 7, "
          f"with the upload {upload_ms:.2f} ms; its device time "
          f"{busy:.3f} ms a call under the profiler "
          f"({', '.join(f'{k} {v:.3f}' for k, v in split_ms.items())}; "
          f"launches kept in the trace of {runs} calls: "
          f"{', '.join(f'{k} {v}' for k, v in kept.items())}), idle "
          f"share {1 - busy / upload_ms:.3f} of the device path, "
          f"{1 - busy / (call_s * 1e3):.5f} of the call; launches {launches} "
          f"[{card}]", flush=True)


# Step 12: config 4 (bench.py:556-584) and the same collation over a shard
# state of REPLAY_ACCOUNTS rows; step 13: config 5 (bench.py:586-605).
CONFIG4_TXS = 64
REPLAY_ACCOUNTS = 4096
STRESS_SHARDS = 1024
STRESS_VOTES = 2
STRESS_TXS = 1
REPLAY_LAUNCHES = {"ecrecover": 1, "keccak_fixed": 2, "replay": 1}
# the warm host marshals timed a scenario (1.0-1.8 s each): cut from 7 so
# that the light client's and the roots' checks fit the smoke's time
REPLAY_MARSHAL_REPS = 3
STRESS_LAUNCHES = {"keccak_fixed": 3, "agg_g1": 1, "agg_g2": 1, "miller": 1,
                   "finalexp": 1, "ecrecover": 1, "replay": 1}


def config4_collation(sp, Transaction, ecdsa, Address20):
    """bench.py's config 4: 64 transfers from one sender (nonces 0-63,
    price 1, gas limit 30,000, value 1, payload b"x"), the recipient as
    coinbase, the sender funded with 10^12."""
    priv = 0xB0B
    sender = Address20(ecdsa.priv_to_address(priv))
    to = Address20(ecdsa.priv_to_address(0xA11CE))
    txs = [sp.sign_transaction(
        Transaction(nonce=i, gas_price=1, gas_limit=30000, to=to, value=1,
                    payload=b"x"), priv) for i in range(CONFIG4_TXS)]
    return txs, {sender: sp.AccountState(balance=10 ** 12)}, to


def replay_path_planes(replay, secp, inp):
    """What `replay_batch` hands its kernels, run on the card: the
    addresses' keccak input (S·T, 64), the replay's 13 planes, and the
    roots' keccak input (S, 60·A) of the replay's outputs."""
    s, t = inp.tx_recid.shape
    flat = lambda x: x.reshape((s * t,) + x.shape[2:])
    qx, qy, ok = secp.ecrecover_batch(flat(inp.tx_e), flat(inp.tx_r),
                                      flat(inp.tx_s), flat(inp.tx_recid),
                                      flat(inp.tx_valid))
    pub = replay.pubkey_bytes(qx, qy)
    senders = replay.keccak256(pub)[..., 12:].reshape(s, t, 20)
    planes = [inp.addrs, inp.nonces, inp.balances, inp.coinbase_ix,
              senders.contiguous(), ok.reshape(s, t), inp.tx_nonce,
              inp.tx_gas_limit, inp.tx_intrinsic, inp.tx_price, inp.tx_value,
              inp.tx_to, inp.tx_valid]
    nonces, balances, _, _ = replay.shard_replay_kernel(*planes)
    return pub, planes, replay.state_blob(inp.addrs, nonces, balances)


def replay_bound(planes, statuses) -> dict:
    """The least time of the replay on these planes: bytes (the tables in
    and out, the transaction planes once, statuses and gas out) against
    operations (per applied transaction 72 32-bit word operations: the two
    products, two compares, the subtraction, the debit and the three row
    updates; per transaction two binary searches of the sorted table,
    ⌈log2 A⌉ compares of 5 words each)."""
    S, A = planes[1].shape
    T = planes[6].shape[1]
    moved = nbytes(*planes) + nbytes(*planes[1:3]) + S * T * (1 + 4)
    applied = int(statuses.sum().item())
    ops = applied * 72 + S * T * 2 * max(1, math.ceil(math.log2(A))) * 5
    return bound(ops, moved)


# The functions' own dependent paths, whatever a design adds to them.
# A keccak-f round: the column parities (two LOP3 levels), rot1 (a funnel
# shift), theta's three-way XOR, rho (a funnel shift), chi and iota: 7
# dependent LOP3-class operations. A transaction of the replay: the
# sender row's balance update, one borrow chain over its 8 words (the
# check is that chain's borrow out; the cost and the other rows' updates
# overlap it): 8 dependent IADD3.
KECCAK_ROUND_OPS = 7
REPLAY_TX_OPS = 8
# What the designs add to those paths (step 12 prints it apart, as
# overhead, never in a bound): keccak_fixed.cu's warp route two
# shared-memory round trips a round (the state into sa and the columns
# out; the pi store into sb and chi's loads); replay.cu's chain a round
# trip through the slot the transaction before stored and a second
# borrow chain of 8 IADD3 (balance - cost, then - value).
KECCAK_WARP_ROUND_TRIPS = 2
REPLAY_TX_EXTRA = (1, 8)


def keccak_route(length: int) -> str:
    """The route keccak_fixed.cu's kernel takes for messages of `length`
    bytes ("warp" or "thread"), on the threshold its source states."""
    from gethsharding_tpu_torch.ops import _build

    found = re.search(r"constexpr int KF_WARP_MIN_LEN = (\d+);",
                      (_build.SRC_DIR / "keccak_fixed.cu").read_text())
    if found is None:
        fail("keccak_fixed.cu states no KF_WARP_MIN_LEN")
    return "warp" if length >= int(found.group(1)) else "thread"


def keccak_chain_ms(length: int, lat: dict) -> float:
    """The least time of one message's sponge of `length` bytes: its
    permutations in turn × 24 rounds × KECCAK_ROUND_OPS dependent LOP3s,
    at the card's measured latency and clock."""
    from gethsharding_tpu_torch.ops import keccak

    cycles = keccak.permutations(1, length) * 24 * KECCAK_ROUND_OPS \
        * lat["lop3"]
    return cycles / lat["sm_hz"] * 1e3


def replay_chain_ms(txs: int, lat: dict) -> float:
    """The least time of one shard's `txs` transactions in turn (shards
    run side by side): REPLAY_TX_OPS dependent IADD3s each."""
    return txs * REPLAY_TX_OPS * lat["iadd3"] / lat["sm_hz"] * 1e3


def with_chain(rate: dict, chain_ms: float) -> dict:
    """A rate bound (`bound`) and a chain bound: the larger is the bound.
    A chain is counted in dependent operations, so it bounds by
    operations."""
    out = dict(rate, chain_ms=chain_ms, rate_ms=rate["bound_ms"])
    if chain_ms > rate["bound_ms"]:
        out.update(bound_ms=chain_ms, bound_by="operations", by="chain")
    else:
        out.update(by=rate["bound_by"])
    return out


def replay_phase(card: str, seed: int) -> list:
    """Step 12: config 4 and the same collation over a state of 4,096
    accounts, and the hostile batch of tests/torch_replay_rows.py. Counted
    from 0 around each `replay_batch`: one recovery, two keccak and one
    replay launch and no other kernel; the statuses of the port's scalar
    replay; the roots equal to `scalar_root_with_padding` and the
    canonical roots to the scalar trie; each new kernel equal to its plain
    version at the path's tensors (tolerance 0); ptxas of both kernels;
    timed beside their bounds; config 4 end to end with its host marshal
    apart. Returns the two kernels' entries of the kernels line."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import torch_replay_rows
    from gethsharding_tpu_torch.core import state_processor as sp
    from gethsharding_tpu_torch.core.types import Transaction
    from gethsharding_tpu_torch.crypto import secp256k1 as ecdsa
    from gethsharding_tpu_torch.das import proofs as das
    from gethsharding_tpu_torch.ops import _build, keccak, replay, route
    from gethsharding_tpu_torch.ops import secp256k1 as secp
    from gethsharding_tpu_torch.utils.hexbytes import Address20

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    txs, genesis, coinbase = config4_collation(sp, Transaction, ecdsa,
                                               Address20)
    rng = np.random.default_rng(seed)
    big = dict(genesis)
    while len(big) < REPLAY_ACCOUNTS - 1:     # the recipient makes 4,096
        addr = Address20(rng.bytes(20))
        if addr != coinbase:
            big[addr] = sp.AccountState(
                nonce=int(rng.integers(0, 1000)),
                balance=int(rng.integers(1, 2 ** 62)) * 10 ** 6)
    hostile = torch_replay_rows.batch(sp, Transaction, ecdsa, Address20)
    scenarios = [("config 4", [txs], [genesis], [coinbase]),
                 (f"config 4 over {REPLAY_ACCOUNTS} accounts", [txs], [big],
                  [coinbase]),
                 ("hostile batch", *hostile)]
    print(f"replay: config 4 ({CONFIG4_TXS} transactions), its state of "
          f"{REPLAY_ACCOUNTS} accounts and the hostile batch "
          f"({sum(map(len, hostile[0]))} transactions over "
          f"{len(hostile[0])} shards) made in {time.perf_counter() - t0:.1f} "
          f"s on the host", flush=True)

    kernel_err = {"keccak_fixed": 0, "replay": 0}
    path = {}
    for label, shard_txs, gens, coins in scenarios:
        t0 = time.perf_counter()
        inp = replay.build_replay_inputs(shard_txs, gens, coins, device=dev)
        torch.cuda.synchronize()
        marshal_s = time.perf_counter() - t0
        for k in _build.KERNELS.values():
            k.launches = 0
        out = replay.replay_batch(inp)
        torch.cuda.synchronize()
        launches = {n: c for n, c in _build.launch_counts().items() if c}
        if launches != REPLAY_LAUNCHES:
            fail(f"replay ({label}) did not run one recovery, two keccak "
                 f"and one replay launch alone: {launches}")
        a_total = inp.addrs.shape[1]
        want_status, want_roots, want_canon = [], [], []
        for stxs, gen, coin in zip(shard_txs, gens, coins):
            state = sp.ShardState({a: sp.AccountState(v.nonce, v.balance)
                                   for a, v in gen.items()})
            for addr in sp.replay_account_table(stxs, state.accounts, coin):
                state.get(addr)
            receipts = sp.process(state, stxs, coin)
            pad = out.statuses.shape[1] - len(stxs)
            want_status.append([r.status == 1 for r in receipts]
                               + [False] * pad)
            want_roots.append(bytes(replay.scalar_root_with_padding(
                state, a_total)))
            want_canon.append(bytes(state.trie_root()))
        if out.statuses.tolist() != want_status:
            fail(f"replay ({label}): statuses differ from the scalar "
                 f"replay's")
        if [bytes(r) for r in out.roots.cpu().numpy()] != want_roots:
            fail(f"replay ({label}): roots differ from the scalar root")
        canon = [bytes(r) for r in replay.canonical_state_roots(inp, out)]
        if canon != want_canon:
            fail(f"replay ({label}): canonical roots differ from the trie")
        # each kernel against its plain version at the path's tensors
        # (the plain versions timed once here)
        pub, planes, rows = replay_path_planes(replay, secp, inp)
        got = replay.shard_replay_kernel(*planes)
        with route.plain_versions():
            want, p_replay = once_ms(lambda: replay.shard_replay(*planes))
        kernel_err["replay"] = max(kernel_err["replay"],
                                   max_abs_err(tuple(got), tuple(want)))
        p_keccak = []
        for msgs in (pub, rows):
            want, ms = once_ms(lambda: keccak.keccak256_fixed(msgs))
            p_keccak.append(ms)
            kernel_err["keccak_fixed"] = max(
                kernel_err["keccak_fixed"],
                max_abs_err(keccak.keccak_fixed_kernel(msgs), want))
        if any(kernel_err.values()):
            fail(f"replay ({label}): a kernel disagrees with its plain "
                 f"version: {kernel_err}")
        print(f"replay ({label}): keccak_fixed routes: the addresses "
              f"({pub.shape[0]} × {pub.shape[1]} B) "
              f"{keccak_route(pub.shape[1])}, the roots "
              f"({rows.shape[0]} × {rows.shape[1]} B) "
              f"{keccak_route(rows.shape[1])}; replay "
              f"{replay.split_blocks(*planes[1].shape)} block(s) a shard",
              flush=True)
        n_ok = int(out.statuses.sum())
        print(f"replay ({label}): {out.statuses.shape[0]} shards × "
              f"{out.statuses.shape[1]} transactions over {a_total} rows, "
              f"{n_ok} applied; launches {launches}; statuses, roots and "
              f"canonical roots equal to the scalar replay's; keccak_fixed "
              f"and replay equal to their plain versions (max |kernel - "
              f"plain| {kernel_err}, tolerance 0); host marshal "
              f"{marshal_s * 1e3:.1f} ms", flush=True)
        path[label] = (inp, out, launches, pub, planes, rows, p_replay,
                       p_keccak)

    for name, source, kern in (("keccak_fixed", "keccak_fixed.cu",
                                "keccak_fixed_kernel"),
                               ("replay", "replay.cu", "replay_kernel")):
        regs, stack, stores, loads = kernel_ptxas(source, kern,
                                                  _build.build_log)
        print(f"kernel {name}: ptxas {regs} registers, stack frame {stack} "
              f"B, spill stores {stores} B, spill loads {loads} B [{card}]",
              flush=True)
        if stack or stores or loads:
            fail(f"{kern} keeps values in local memory")

    # times at the 4,096-row state: each kernel beside its bound (the
    # larger of its rate bound and its chain) and its plain version, per
    # replay_batch; the replay at config 4 too
    lat = chain_latencies()
    print(f"chain latencies (one warp, each feeding the next): LOP3 "
          f"{lat['lop3']:.2f}, SHF {lat['shf']:.2f}, IADD3 "
          f"{lat['iadd3']:.2f} cycles, shared-memory round trip "
          f"{lat['smem_round_trip']:.2f} cycles; SM clock "
          f"{lat['sm_hz'] / 1e9:.4f} GHz [{card}]", flush=True)
    (inp, out, launches, pub, planes, rows, p_replay,
     (p_pub, p_root)) = path[scenarios[1][0]]
    k_pub = cuda_ms(lambda: keccak.keccak_fixed_kernel(pub), 20)
    k_root = cuda_ms(lambda: keccak.keccak_fixed_kernel(rows), 5)
    k_replay = cuda_ms(lambda: replay.shard_replay_kernel(*planes), 20)
    perms_pub = keccak.permutations(*pub.shape)
    perms_root = keccak.permutations(*rows.shape)
    pub_bound = with_chain(
        bound(perms_pub * das.PERMUTATION_OPS,
              nbytes(pub) + 32 * pub.shape[0]),
        keccak_chain_ms(pub.shape[1], lat))
    root_bound = with_chain(
        bound(perms_root * das.PERMUTATION_OPS, nbytes(rows) + 32),
        keccak_chain_ms(rows.shape[1], lat))
    keccak_bound = {"bound_by": "operations", "bound_ms":
                    pub_bound["bound_ms"] + root_bound["bound_ms"]}
    rep_bound = with_chain(replay_bound(planes, out.statuses),
                           replay_chain_ms(planes[6].shape[1], lat))
    root_cycles = k_root / perms_root * 1e-3 * lat["sm_hz"]
    print(f"time keccak_fixed (config 4 over {REPLAY_ACCOUNTS} accounts, "
          f"per replay_batch: the addresses, {pub.shape[0]} × {pub.shape[1]} "
          f"B, {perms_pub} permutations, {keccak_route(pub.shape[1])} "
          f"route, {k_pub:.4f} ms, bound {pub_bound['bound_ms']:.6f} ms "
          f"({pub_bound['by']}); the root, one message of {rows.shape[1]} B, "
          f"{perms_root} permutations in turn on the "
          f"{keccak_route(rows.shape[1])} route, {k_root:.4f} ms, its "
          f"chain bound {root_bound['chain_ms']:.4f} ms (24 rounds × "
          f"{KECCAK_ROUND_OPS} dependent LOP3 a permutation), "
          f"{root_bound['bound_ms'] / k_root:.1%} of it, its rate bound "
          f"{root_bound['rate_ms']:.6f} ms): kernel "
          f"{k_pub + k_root:.4f} ms, plain {p_pub + p_root:.1f} ms, bound "
          f"{keccak_bound['bound_ms']:.4f} ms (operations, the chains), "
          f"{keccak_bound['bound_ms'] / (k_pub + k_root):.1%} of its bound; "
          f"the root's sponge {k_root / perms_root * 1e3:.3f} µs a "
          f"permutation, {root_cycles / 24:.0f} cycles a round [{card}]",
          flush=True)
    c4 = path[scenarios[0][0]]
    c4_planes, c4_out, c4_plain = c4[4], c4[1], c4[6]
    k_c4 = cuda_ms(lambda: replay.shard_replay_kernel(*c4_planes), 20)
    c4_bound = with_chain(replay_bound(c4_planes, c4_out.statuses),
                          replay_chain_ms(c4_planes[6].shape[1], lat))
    for label, ms, plain_ms, r, pl in (
            (f"config 4 over {REPLAY_ACCOUNTS} accounts", k_replay,
             p_replay, rep_bound, planes),
            ("config 4", k_c4, c4_plain, c4_bound, c4_planes)):
        S, A = pl[1].shape
        print(f"time replay ({label}, {pl[6].shape[1]} transactions, "
              f"{replay.split_blocks(S, A)} block(s) of 256 threads a "
              f"shard): kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
              f"{r['bound_ms']:.6f} ms ({r['by']}: chain "
              f"{r['chain_ms']:.6f} ms of {pl[6].shape[1]} transactions × "
              f"{REPLAY_TX_OPS} dependent IADD3; rate {r['rate_ms']:.6f} "
              f"ms, {r['bytes']} B), {r['bound_ms'] / ms:.1%} of its bound "
              f"[{card}]", flush=True)
    # the designs' trips beyond the functions' chains, apart from the
    # bounds: cycles a round or transaction, and over this run's chain
    k_round = KECCAK_ROUND_OPS * lat["lop3"]
    k_extra = KECCAK_WARP_ROUND_TRIPS * lat["smem_round_trip"]
    r_tx = REPLAY_TX_OPS * lat["iadd3"]
    r_extra = REPLAY_TX_EXTRA[0] * lat["smem_round_trip"] \
        + REPLAY_TX_EXTRA[1] * lat["iadd3"]
    T = planes[6].shape[1]
    print(f"design overhead beyond the chains (in no bound): keccak_fixed's "
          f"warp route {KECCAK_WARP_ROUND_TRIPS} shared-memory round trips "
          f"a round, {k_extra:.2f} cycles beside the chain's {k_round:.2f} "
          f"({k_extra * 24 * perms_root / lat['sm_hz'] * 1e3:.4f} ms over "
          f"the root's {perms_root} permutations); replay's chain "
          f"{REPLAY_TX_EXTRA[0]} slot round trip and {REPLAY_TX_EXTRA[1]} "
          f"more IADD3 a transaction, {r_extra:.2f} cycles beside the "
          f"chain's {r_tx:.2f} ({r_extra * T / lat['sm_hz'] * 1e3:.6f} ms "
          f"over {T} transactions) [{card}]", flush=True)

    # config 4 end to end: the host marshal apart from the device path
    for label, shard_txs, gens, coins in scenarios[:2]:
        inp = replay.build_replay_inputs(shard_txs, gens, coins, device=dev)
        marshal_ms = host_ms(lambda: replay.build_replay_inputs(
            shard_txs, gens, coins, device=dev), REPLAY_MARSHAL_REPS)
        device_ms = host_ms(lambda: replay.replay_batch(inp).roots.cpu(), 7)
        runs = 5
        split_ms, kept = traced_calls(
            lambda: replay.replay_batch(inp).roots.cpu(), runs,
            {"ecrecover_kernel": 1, "keccak_fixed_kernel": 2,
             "replay_kernel": 1})
        busy = sum(split_ms.values())
        print(f"time replay_batch ({label}, warm): host marshal "
              f"{marshal_ms:.2f} ms (median of {REPLAY_MARSHAL_REPS}); "
              f"device path (median of 7) with the roots' "
              f"pull {device_ms:.3f} ms, {CONFIG4_TXS / device_ms * 1e3:.0f} "
              f"txs/s ({CONFIG4_TXS / (marshal_ms + device_ms) * 1e3:.0f} "
              f"with the marshal); device time {busy:.3f} ms a call "
              f"({', '.join(f'{k} {v:.4f}' for k, v in split_ms.items())}; "
              f"launches kept in a trace of {runs} calls: "
              f"{', '.join(f'{k} {v}' for k, v in kept.items())}), idle "
              f"share {1 - busy / device_ms:.3f} of the device path "
              f"[{card}]", flush=True)

    launches = path[scenarios[1][0]][2]
    entry = lambda name, kernel, ms, plain_ms, r: {
        "name": name, "route": "cuda", "source": kernel.source,
        "replaces": kernel.replaces, "launches": launches[name],
        "max_abs_err": kernel_err[name], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None}
    return [entry("keccak_fixed", keccak.KERNEL, k_pub + k_root,
                  p_pub + p_root, keccak_bound),
            entry("replay", replay.KERNEL, k_replay, p_replay, rep_bound)]


def start_stress_build(seed: int):
    """Start step 13's host build (`build_stress_inputs` on the CPU, a
    minute of Python EC arithmetic) in a process of its own, so that it
    runs beside steps 1-12 (it uses the host only); returns (process,
    output path, start time)."""
    import tempfile

    import atexit

    path = os.path.join(tempfile.mkdtemp(prefix="chip-stress-"), "inputs.pt")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--stress-inputs", path,
         "--seed", str(seed)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    # a phase failing before step 13 takes it: the build stops with us
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, path, time.perf_counter()


def stress_inputs(path: str, seed: int) -> int:
    """The `--stress-inputs PATH` mode: step 13's inputs built on the CPU
    and saved to PATH (the same inputs as on the card: the builder's
    draws and host crypto do not depend on the device)."""
    from gethsharding_tpu_torch.parallel import stress

    t0 = time.perf_counter()
    inputs, pool, bh, size, _ = stress.build_stress_inputs(
        STRESS_SHARDS, votes_per_shard=STRESS_VOTES,
        txs_per_shard=STRESS_TXS, committee_size=COMMITTEE, seed=seed + 7,
        device="cpu")
    torch.save({"inputs": inputs._asdict(), "pool": torch.from_numpy(pool),
                "bh": torch.from_numpy(bh), "size": size,
                "build_s": time.perf_counter() - t0}, path)
    return 0


# the trie family's roots (`core/mpt.py`, `core/derive_sha.py`,
# `state_processor.state_trie_root`): host code by design, so a process of
# its own from the build to step 13, beside step 13's host build
ROOT_LENGTHS = (0, 1, 63, 64) + tuple(range(127, 301))
ROOT_BODIES = (1 << 16, 1 << 20)     # chunk_root's timed bodies, in bytes


def start_roots_phase(seed: int):
    """Start the `--roots-phase` process; returns (process, start time)."""
    import atexit

    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--roots-phase",
         "--seed", str(seed)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, time.perf_counter()


def finish_roots_phase(started) -> None:
    """Wait for the `--roots-phase` process and print what it printed;
    fails where it failed."""
    proc, t0 = started
    try:
        out, _ = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail("roots: the phase did not finish within 300 s")
    print(out.rstrip(), flush=True)
    if proc.returncode != 0:
        fail(f"roots: the phase exited {proc.returncode}")
    print(f"roots phase: {time.perf_counter() - t0:.1f} s from its start "
          f"to its reading, beside steps 9-12", flush=True)


def roots_phase(seed: int) -> int:
    """The `--roots-phase` mode: the compiled trie root (`csrc/mpt.c` with
    `csrc/keccak.c`, built by `cc` on the card's machine) loaded (fails
    where it did not), its roots equal to the Python trie's on the lists
    the CPU tests hold: the empty list, 1, 63 and 64 items and every
    length from 127 to 300 (each rlp(uint) key boundary), seeded pairs
    with duplicate keys, values of 55 to 64 bytes, and the state tables of
    `tests/torch_replay_rows.py` before and after its scalar replay (the
    native state root against the Python one); lists past the caps (a
    33-byte key, a 129-byte value) refused to the Python route. Timed on
    the host (one busy core beside it): `chunk_root` of a 64 KiB body by
    both routes, and of a 1 MiB body by the native route."""
    from gethsharding_tpu_torch.core import derive_sha as ds
    from gethsharding_tpu_torch.core import mpt
    from gethsharding_tpu_torch.core import state_processor as sp
    from gethsharding_tpu_torch.core.trie import Trie
    from gethsharding_tpu_torch.core.types import Transaction
    from gethsharding_tpu_torch.crypto import secp256k1 as ecdsa
    from gethsharding_tpu_torch.utils.hexbytes import Address20
    from gethsharding_tpu_torch.utils.rlp import int_to_big_endian, rlp_encode

    card = card_line()
    t_phase = time.perf_counter()
    if not mpt.native_available():
        fail("roots: the compiled trie root (csrc/mpt.c) did not build or "
             "load on this machine")

    def python_root(pairs) -> bytes:
        trie = Trie()
        for k, v in pairs:
            trie.update(k, v)
        return trie.root_hash()

    lists = []
    for n in ROOT_LENGTHS:
        lists.append(([rlp_encode(int_to_big_endian(i)) for i in range(n)],
                      [rlp_encode(i % 256) for i in range(n)]))
    rng = np.random.default_rng(seed + 23)
    for _ in range(3):
        pairs = [(bytes(rng.integers(0, 256, int(rng.integers(1, 9)),
                                     dtype=np.uint8)),
                  bytes(rng.integers(0, 256, int(rng.integers(1, 65)),
                                     dtype=np.uint8))) for _ in range(400)]
        pairs += [(k, v[::-1] + b"!") for k, v in pairs[::7]]
        lists.append(([k for k, _ in pairs], [v for _, v in pairs]))
    for vlen in range(55, 65):
        lists.append(([bytes([i]) for i in range(70)],
                      [bytes([i]) * vlen for i in range(70)]))
    for keys, vals in lists:
        if mpt.mpt_root(keys, vals) != python_root(zip(keys, vals)):
            fail(f"roots: the native root of a list of {len(keys)} differs "
                 f"from the Python trie's")
    for keys, vals in (([b"k" * 33], [b"v"]), ([b"k"], [b"v" * 129])):
        if mpt.mpt_root(keys, vals) is not None:
            fail("roots: a list past the caps took the native route")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import torch_replay_rows

    txs, genesis, coinbases = torch_replay_rows.batch(sp, Transaction, ecdsa,
                                                      Address20)
    native0 = sp.m_native_state_roots.value
    tables = 0
    for shard_txs, gen, coin in zip(txs, genesis, coinbases):
        state = sp.ShardState({a: sp.AccountState(v.nonce, v.balance)
                               for a, v in gen.items()})
        for _ in range(2):
            if sp.state_trie_root(state.accounts) \
                    != sp.python_state_trie_root(state.accounts):
                fail("roots: a native state root differs from the Python "
                     "trie's")
            tables += 1
            sp.process(state, shard_txs, coin)
    if sp.m_native_state_roots.value - native0 != tables:
        fail("roots: a state root of the replay tables took the Python "
             "route")
    print(f"roots: the native route (csrc/mpt.c) equal to the Python trie "
          f"on {len(lists)} lists (lengths 0, 1, 63, 64, 127-300, seeded "
          f"pairs with duplicate keys, values of 55-64 B), {tables} state "
          f"tables of tests/torch_replay_rows.py (before and after their "
          f"replay); lists past the caps take the Python route; "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    times = []
    for size in ROOT_BODIES:
        body = bytes(rng.integers(0, 256, size, dtype=np.uint8))
        t0 = time.perf_counter()
        root = ds.chunk_root(body)
        native_s = time.perf_counter() - t0
        line = (f"{size // 1024} KiB: native route {native_s * 1e3:.1f} ms "
                f"(the Python lists of {size} keys and items included)")
        if size <= 1 << 16:
            t0 = time.perf_counter()
            twin = ds.python_derive_sha([rlp_encode(int(b)) for b in body])
            python_s = time.perf_counter() - t0
            if twin != root:
                fail(f"roots: chunk_root of {size} B differs between the "
                     f"routes")
            line += f", Python trie {python_s * 1e3:.1f} ms (equal roots)"
        times.append(line)
    print(f"time chunk_root (host of the card's machine, beside step 13's "
          f"host build and the card's steps): {'; '.join(times)} [{card}]",
          flush=True)
    return 0


def stress_phase(card: str, seed: int, started):
    """Step 13: config 5 on one card, 1,024 shards, 2 votes and 1
    transaction a shard, a pool of 135, at quorum 90 (nothing elected)
    and at quorum 2 (every shard elects). Counted from 0 around each
    `StressPipeline.run`: 3 keccak (sampling, addresses, roots) and one
    launch of each committee-sum, Miller, final-exponentiation, recovery
    and replay kernel, normalizes as glue; every attempt accepted, every
    aggregate and transaction valid, 2,048 votes; equal to the plain
    versions on the card; timed warm with its split by kernel and the
    idle share. Returns its inputs (inputs, pool, blockhash, sample size)
    for step 19."""
    from gethsharding_tpu_torch.ops import _build, route
    from gethsharding_tpu_torch.parallel import stress
    from gethsharding_tpu_torch.params import Config

    dev = torch.device("cuda")
    proc, path, t0 = started
    try:
        out, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail("step 13: the host build did not finish within 600 s")
    waited = time.perf_counter()
    if proc.returncode != 0:
        fail(f"step 13: the host build exited {proc.returncode}:\n"
             f"{out[-3000:]}")
    built = torch.load(path)
    inputs = stress.StressInputs(**{k: v.to(dev) for k, v in
                                    built["inputs"].items()})
    pool, bh, size = built["pool"].numpy(), built["bh"].numpy(), built["size"]
    torch.cuda.synchronize()
    print(f"stress build: build_stress_inputs({STRESS_SHARDS}, "
          f"votes_per_shard={STRESS_VOTES}, txs_per_shard={STRESS_TXS}, "
          f"committee_size={COMMITTEE}) {built['build_s']:.1f} s on the host, "
          f"in a process of its own beside steps 1-12 (started "
          f"{waited - t0:.1f} s before this step took it) [{card}]",
          flush=True)
    votes = STRESS_SHARDS * STRESS_VOTES
    plain = None
    for quorum, elected in ((Config().quorum_size, 0), (2, STRESS_SHARDS)):
        pipe = stress.StressPipeline(Config(quorum_size=quorum))
        run = lambda: pipe.run(inputs, pool, bh, 1, size)
        for k in _build.KERNELS.values():
            k.launches = 0
        out = run()
        torch.cuda.synchronize()
        launches = {n: c for n, c in _build.launch_counts().items() if c}
        if {k: v for k, v in launches.items() if k != "norm"} \
                != STRESS_LAUNCHES:
            fail(f"the stress step (quorum {quorum}) ran other launches: "
                 f"{launches}")
        if not (bool(out.accepted.all()) and bool(out.agg_ok.all())
                and bool(out.tx_status.all())):
            fail(f"the stress step (quorum {quorum}) rejected a vote, an "
                 f"aggregate or a transaction")
        totals = (int(out.total_votes), int(out.total_elected),
                  int(out.total_txs))
        if totals != (votes, elected, STRESS_SHARDS * STRESS_TXS):
            fail(f"the stress step (quorum {quorum}) totals {totals}")
        # the plain versions once, at quorum 90: the quorum moves only
        # is_elected and its total, checked above
        if plain is None:
            with route.plain_versions():
                plain, plain_ms = once_ms(run)
        same = [n for n in stress.StressOutputs._fields
                if n not in ("is_elected", "total_elected")
                or quorum == Config().quorum_size]
        diff = [n for n in same
                if not torch.equal(getattr(out, n), getattr(plain, n))]
        if diff:
            fail(f"the stress step (quorum {quorum}) differs from its plain "
                 f"versions in {diff}")
        if not bool(out.is_elected.all() if elected else
                    ~out.is_elected.any()):
            fail(f"the stress step (quorum {quorum}) elected "
                 f"{int(out.is_elected.sum())} shards")
        step_ms = host_ms(lambda: run().total_txs.item(), 7)
        runs = 5
        split_ms, kept = traced_calls(
            lambda: run().total_txs.item(), runs,
            {"keccak_fixed_kernel": 3, "agg_kernel": 2, "miller_kernel": 1,
             "finalexp_kernel": 1, "ecrecover_kernel": 1,
             "replay_kernel": 1, "norm_kernel": launches.get("norm", 0)})
        busy = sum(split_ms.values())
        print(f"stress step (quorum {quorum}): {STRESS_SHARDS} shards, "
              f"totals votes {totals[0]}, elected {totals[1]}, txs "
              f"{totals[2]}; launches {launches}; equal to the plain "
              f"versions (their run at quorum 90: {plain_ms:.0f} ms on the "
              f"card)", flush=True)
        print(f"time stress step (quorum {quorum}, warm, median of 7, to "
              f"the totals' pull): {step_ms:.2f} ms, "
              f"{STRESS_SHARDS / step_ms * 1e3:.0f} shards/s; device time "
              f"{busy:.3f} ms a step "
              f"({', '.join(f'{k} {v:.3f}' for k, v in split_ms.items())}; "
              f"launches kept in a trace of {runs} steps: "
              f"{', '.join(f'{k} {v}' for k, v in kept.items())}), idle "
              f"share {1 - busy / step_ms:.3f} [{card}]", flush=True)
        for name, r in stress_pairing_bounds(STRESS_SHARDS).items():
            ms = split_ms.get(f"{name}_kernel", float("nan"))
            print(f"bound {name} at {STRESS_SHARDS} rows (quorum {quorum}; "
                  f"every row paired, the 112-row count a row): "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}: "
                  f"{r['multiply_adds']} multiply-adds, {r['bytes']} B); "
                  f"its device time {ms:.3f} ms a step, "
                  f"{r['bound_ms'] / ms:.1%} of its bound [{card}]",
                  flush=True)
    return inputs, pool, bh, size


@functools.lru_cache(maxsize=None)
def stress_pairing_bounds(rows: int) -> dict:
    """The operation bounds of `miller` and `finalexp` at `rows` paired
    rows, with the 112-row bounds' counts (main): a row's int32
    multiply-adds from a one-row run of the plain version (three
    schoolbooks per Fp2 product), its bytes from its planes' widths."""
    from gethsharding_tpu_torch.ops import megakernels as mk

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    limbs = lambda *shape: torch.randint(
        0, 1 << 12, (1,) + shape + (mk.KNL,), generator=gen, device=dev,
        dtype=torch.int32)
    sig, h = (limbs(), limbs(), limbs()), (limbs(), limbs())
    pk = (limbs(2), limbs(2), limbs(2))
    nd = limbs(2, 6, 2)
    g2_pt = 2 * mk.KNL * 4
    work = {"miller": (lambda: mk.run_miller_plain(sig, h, pk),
                       nbytes(*sig, *h, *pk) + 6 * g2_pt,
                       mk._MILLER_LINES.nbytes),
            "finalexp": (lambda: mk.run_program_plain(nd), 2 * nbytes(nd),
                         mk._PROGRAM.nbytes)}
    return {name: bound(count_multiply_adds(mk, fn, karatsuba=True) * rows,
                        row_bytes * rows + fixed)
            for name, (fn, row_bytes, fixed) in work.items()}


# step 14: the notary service on the card, on config 5's pool (100 shards,
# committee 135, a pool of 135 members)
NOTARY_POOL = 135
NOTARY_AUDIT = ("agg_g1", "finalexp", "keccak_fixed")


def notary_chain(mods, cfg, members):
    """The port's `SimulatedMainchain(cfg)` with `members` funded and
    registered in pool order (BLS pubkeys and proofs of possession),
    sealed to the last block of period 0. Returns (chain, clients)."""
    chain = mods.SimulatedMainchain(cfg)
    clients = []
    for acct in members:
        chain.fund(acct.address)
        client = mods.SMCClient(backend=chain, accounts=mods.am,
                                account=acct, config=cfg)
        client.register_notary()
        clients.append(client)
    while chain.block_number < cfg.period_length - 1:
        chain.commit()
    return chain, clients


def period_eligibility(mods, chain, cfg, period: int) -> dict:
    """Pool index -> the shards the SMC samples it for in `period` (the
    committee keccak over the last block of the period before)."""
    bh = bytes(chain.blockhash(period * cfg.period_length - 1))
    size = len(chain.smc.notary_pool)
    out = {}
    for i in range(size):
        prefix = bh + i.to_bytes(32, "big")
        out[i] = [s for s in range(cfg.shard_count)
                  if int.from_bytes(mods.keccak256(
                      prefix + s.to_bytes(32, "big")), "big") % size == i]
    return out


def propose_period(mods, chain, kv, period: int, proposer, impostor,
                   bad_sig=(), no_body=()) -> None:
    """A signed header on every shard of `period` (one transaction a
    body), the bodies in the shard DB `kv`; shards in `bad_sig` are signed
    by `impostor`, those in `no_body` keep no body."""
    for shard in range(chain.config.shard_count):
        tx = mods.Transaction(nonce=shard, gas_limit=21000, value=period,
                              payload=b"collation %d/%d" % (period, shard))
        body = mods.serialize_txs_to_blob([tx])
        root = mods.Collation(header=mods.CollationHeader(),
                              body=body).calculate_chunk_root()
        header = mods.CollationHeader(shard_id=shard, chunk_root=root,
                                      period=period,
                                      proposer_address=proposer.address)
        signer = impostor if shard in bad_sig else proposer
        header.add_sig(mods.ecdsa.sign(bytes(header.hash()),
                                       signer.priv).to_bytes65())
        chain.add_header(proposer.address, shard, period, root,
                         header.proposer_signature)
        if shard not in no_body:
            mods.Shard(shard, kv).save_body(body)


def notary_modules():
    from types import SimpleNamespace

    from gethsharding_tpu_torch.actors.notary import Notary
    from gethsharding_tpu_torch.core.shard import Shard
    from gethsharding_tpu_torch.core.types import (Collation,
                                                   CollationHeader,
                                                   Transaction,
                                                   serialize_txs_to_blob)
    from gethsharding_tpu_torch.crypto import bn256 as bls
    from gethsharding_tpu_torch.crypto import secp256k1 as ecdsa
    from gethsharding_tpu_torch.crypto.keccak import keccak256
    from gethsharding_tpu_torch.db.kv import MemoryKV
    from gethsharding_tpu_torch.mainchain.accounts import AccountManager
    from gethsharding_tpu_torch.mainchain.client import SMCClient
    from gethsharding_tpu_torch.params import Config
    from gethsharding_tpu_torch.smc.chain import SimulatedMainchain
    from gethsharding_tpu_torch.smc.state_machine import vote_digest

    return SimpleNamespace(
        Notary=Notary, Shard=Shard, Collation=Collation,
        CollationHeader=CollationHeader, Transaction=Transaction,
        serialize_txs_to_blob=serialize_txs_to_blob, bls=bls, ecdsa=ecdsa,
        keccak256=keccak256, MemoryKV=MemoryKV, SMCClient=SMCClient,
        Config=Config, SimulatedMainchain=SimulatedMainchain,
        vote_digest=vote_digest, am=AccountManager())


def launches_of(fn):
    """(fn's result, the kernel launches it made, counted from 0)."""
    from gethsharding_tpu_torch.ops import _build

    for k in _build.KERNELS.values():
        k.launches = 0
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, {n: c for n, c in _build.launch_counts().items() if c}


def launches_aside(fn):
    """`launches_of` inside a run whose own counts are read after it:
    fn's launches counted from 0, then every count put back with fn's
    added to it."""
    from gethsharding_tpu_torch.ops import _build

    saved = _build.launch_counts()
    out, got = launches_of(fn)
    for name, k in _build.KERNELS.items():
        k.launches += saved[name]
    return out, got


def notary_run(mods, quorum: int, members, proposer, impostor,
               backend) -> dict:
    """Step 14's script at one quorum: the chain built, the notary under
    test started among the pool, period 1 proposed (hostile rows on the
    notary's own candidates) and voted, closed, one stored vote signature
    forged, period 2 proposed, and the auditing head counted. Fails on
    any answer other than the known one. Returns what the timings use."""
    cfg = mods.Config(quorum_size=quorum)
    t0 = time.perf_counter()
    chain, clients = notary_chain(mods, cfg, members)
    build_s = time.perf_counter() - t0
    # the notary under test: the member sampled for the most shards in
    # period 1; its own shard is the first of them, the second gets a
    # header signed by another key, the third loses its body
    elig = period_eligibility(mods, chain, cfg, 1)
    me = max(elig, key=lambda i: (len(elig[i]), -i))
    mine = elig[me]
    if len(mine) < 3:
        fail(f"step 14: no member is sampled for 3 shards in period 1 "
             f"({mine})")
    own, bad_sig, no_body = mine[:3]
    kv = mods.MemoryKV()
    notary = mods.Notary(client=clients[me], shard=mods.Shard(own, kv),
                         config=cfg, sig_backend=backend)
    notary.start()
    t0 = time.perf_counter()
    propose_period(mods, chain, kv, 1, proposer, impostor, (bad_sig,),
                   (no_body,))
    chain.commit()          # head 5: the notary votes first
    voted = 0
    for i, client in enumerate(clients):
        if i == me:
            continue
        for shard in elig[i]:
            rec = chain.collation_record(shard, 1)
            client.submit_vote(
                shard, 1, i, rec.chunk_root,
                bls_sig=client.bls_sign(mods.vote_digest(shard, 1,
                                                         rec.chunk_root)))
            voted += 1
    while chain.block_number < 2 * cfg.period_length - 1:
        chain.commit()      # period 1 closes at block 9
    period_s = time.perf_counter() - t0
    # the heads of blocks 5-8 vote in period 1 (block 9's pending block is
    # in period 2); each rejects the header signed by another key
    heads = cfg.period_length - 1
    if (notary.votes_submitted, notary.signatures_rejected) != (1, heads):
        fail(f"step 14 (quorum {quorum}): the notary voted "
             f"{notary.votes_submitted} times and rejected "
             f"{notary.signatures_rejected} signatures; want 1 and {heads}")
    if not any(f"unavailable for shard {no_body} period 1" in e
               for e in notary.errors):
        fail(f"step 14: the notary voted on shard {no_body} without its "
             f"body")
    data = chain.smc.collation_records
    voted_shards = sorted(s for (s, p), r in data.items()
                          if p == 1 and r.vote_sigs)
    elected = sorted(s for (s, p), r in data.items()
                     if p == 1 and r.is_elected)
    if elected != (voted_shards if quorum == 1 else []):
        fail(f"step 14 (quorum {quorum}): elected shards {elected}")
    canonical = []
    if quorum == 1:
        header = notary._reconstruct_header(own, 1, data[(own, 1)])
        if (notary.canonical_set != 1
                or notary.shard.canonical_header_hash(own, 1)
                != header.hash()):
            fail("step 14 (quorum 1): the notary did not set its shard's "
                 "canonical header")
        canonical = [own]
    elif notary.canonical_set:
        fail("step 14 (quorum 90): the notary set a canonical header")
    # after the period closes: one stored vote signature forged
    forged = voted_shards[0]
    vote = data[(forged, 1)].vote_sigs[min(data[(forged, 1)].vote_sigs)]
    honest_sig = vote.sig
    vote.sig = mods.bls.g1_add(vote.sig, mods.bls.G1_GEN)
    propose_period(mods, chain, kv, 2, proposer, impostor)
    mismatches = notary.audit_mismatches
    _, head = launches_of(chain.commit)      # head 10: audits period 1
    errors = [e for e in notary.errors if e.startswith("period 1 ")]
    n = len(data[(forged, 1)].vote_sigs)
    want = [f"period 1 audit mismatch on shard {forged}: invalid aggregate "
            f"signature ({n}/{n} votes signed)"]
    if notary.audit_mismatches - mismatches != 1 or errors != want:
        fail(f"step 14 (quorum {quorum}): the auditing head reported "
             f"{errors}; want {want}")
    failed = [e for e in notary.errors if e.startswith("notarize failed")]
    if failed or notary.crashed:
        fail(f"step 14 (quorum {quorum}): a head failed: {failed}")
    check_audit_launches(f"the auditing head (quorum {quorum})", head,
                         cold=True)
    vote.sig = honest_sig
    result, warm = launches_of(lambda: notary.audit_periods([1]))
    if result != {1: True}:
        fail(f"step 14 (quorum {quorum}): the clean rerun gave {result}")
    check_audit_launches(f"audit_periods([1]) (quorum {quorum})", warm,
                         cold=False)
    result, none = launches_of(lambda: notary.audit_periods([0]))
    if result != {0: None} or none:
        fail(f"step 14: the empty period gave {result}, launches {none}")
    replay, vlaunch = launches_of(
        lambda: chain.verify_period_batch(1, device=backend.device))
    if replay is not True or vlaunch != {"keccak_fixed": 1}:
        fail(f"step 14: verify_period_batch(1) gave {replay}, launches "
             f"{vlaunch}")
    return {"chain": chain, "notary": notary, "head": head, "warm": warm,
            "build_s": build_s, "period_s": period_s, "voted": voted,
            "rows": len(voted_shards), "me": me, "mine": mine,
            "forged": forged, "canonical": canonical}


def check_audit_launches(what: str, launched: dict, cold: bool) -> None:
    """One precomp audit (one `agg_g1`, tower launches, one `finalexp`;
    the cold one also one `agg_g2` for the new tables), the replay's one
    `keccak_fixed`, normalizes as glue, at most one `ecrecover` for a
    head's vote phase, and no other kernel."""
    allowed = set(NOTARY_AUDIT) | {"tower", "norm", "ecrecover"} \
        | ({"agg_g2"} if cold else set())
    if any(launched.get(k) != 1 for k in NOTARY_AUDIT) \
            or not launched.get("tower") or set(launched) - allowed \
            or launched.get("ecrecover", 0) > 1 \
            or launched.get("agg_g2", 0) > 1:
        fail(f"step 14: {what} ran launches {launched}")


# the port's kernels by the profiler's label
NOTARY_LABELS = {"agg_g1": "agg_kernel", "agg_g2": "agg_kernel",
                 "finalexp": "finalexp_kernel", "tower": "tower_kernel",
                 "norm": "norm_kernel", "keccak_fixed": "keccak_fixed_kernel",
                 "ecrecover": "ecrecover_kernel"}


def notary_phase(card: str, seed: int):
    """Step 14: the notary service on config 5's pool, at quorum 90
    (nothing elects) and quorum 1 (every voted shard elects, and the
    notary sets its own shard's canonical header), checked by
    `notary_run`; at quorum 90 the audit also through the plain versions
    on the card, and timed warm: the auditing head end to end,
    `audit_periods([1])` split into its row collection, backend call and
    judge, `verify_period_batch` alone, and the head's kernels under the
    profiler with the card's idle share. Returns (the account manager, the
    members), whose keys step 15 reuses."""
    from gethsharding_tpu_torch.ops import route
    from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend

    mods = notary_modules()
    t_step = t0 = time.perf_counter()
    members = [mods.am.new_account(seed=b"chip-notary-%d-%d" % (seed, i))
               for i in range(NOTARY_POOL)]
    proposer = mods.am.new_account(seed=b"chip-notary-proposer-%d" % seed)
    impostor = mods.am.new_account(seed=b"chip-notary-impostor-%d" % seed)
    for acct in members:
        acct.bls_keypair()
    keys_s = time.perf_counter() - t0
    runs = {}
    for quorum in (mods.Config().quorum_size, 1):
        run = notary_run(mods, quorum, members, proposer, impostor,
                         TorchSigBackend())
        runs[quorum] = run
        print(f"notary chain build (quorum {quorum}): SimulatedMainchain("
              f"Config(quorum_size={quorum})), {NOTARY_POOL} members funded "
              f"and registered with BLS pubkeys and proofs of possession: "
              f"{run['build_s']:.1f} s on the host (the members' BLS key "
              f"derivation, once for both quorums: {keys_s:.1f} s); period "
              f"1 proposed (100 signed headers) and voted ({run['voted']} "
              f"votes of the other members): {run['period_s']:.1f} s",
              flush=True)
        print(f"notary (quorum {quorum}): member {run['me']} sampled for "
              f"shards {run['mine']} (own shard, a header signed by another "
              f"key, a missing body); auditing head: period 1 False (the "
              f"forged vote on shard {run['forged']}), launches "
              f"{run['head']}; clean rerun True, launches {run['warm']}; "
              f"period 0 None; verify_period_batch(1) True on the card "
              f"(one keccak_fixed); {run['rows']} audited rows; canonical "
              f"headers set {run['canonical']}", flush=True)
    run = runs[mods.Config().quorum_size]
    notary, chain = run["notary"], run["chain"]
    with route.plain_versions():
        plain = (notary.audit_periods([1]),
                 chain.verify_period_batch(1, device="cuda"))
    if plain != ({1: True}, True):
        fail(f"step 14: the plain versions on the card gave {plain}")
    period = 2 * chain.config.period_length

    def head():
        notary._last_audited_period = 1
        notary.notarize_collations(head=period)

    _, counted = launches_of(head)
    check_audit_launches("the warm auditing head", counted, cold=False)
    head_ms = host_ms(head, 7)
    per_call = collections.Counter()
    for name, count in counted.items():
        per_call[NOTARY_LABELS[name]] += count
    split_ms, kept = traced_calls(head, 5, per_call)
    busy = sum(split_ms.values())
    rows = notary._collect_audit_rows(1)
    call = lambda: notary.sig_backend.bls_verify_committees(
        rows["msgs"], rows["sig_rows"], rows["pk_rows"],
        pk_row_keys=rows["pk_keys"])
    ok = call()
    parts = {"_collect_audit_rows": lambda: notary._collect_audit_rows(1),
             "bls_verify_committees": call,
             "_judge_period": lambda: notary._judge_period(1, rows, ok)}
    part_ms = {k: host_ms(fn, 7) for k, fn in parts.items()}
    audit_ms = host_ms(lambda: notary.audit_periods([1]), 7)
    verify_ms = host_ms(lambda: chain.verify_period_batch(1), 7)
    votes = sum(len(r) for r in rows["sig_rows"])
    print(f"time notary auditing head (quorum 90, warm, median of 7): "
          f"{head_ms:.2f} ms end to end (the audit of period 1: "
          f"{len(rows['msgs'])} rows, {votes} votes; the vote phase of "
          f"period 2); launches {counted}; device time {busy:.3f} ms a "
          f"head ({', '.join(f'{k} {v:.3f}' for k, v in split_ms.items())}"
          f"; launches kept in a trace of 5 heads: "
          f"{', '.join(f'{k} {v}' for k, v in kept.items())}), idle share "
          f"{1 - busy / head_ms:.3f} [{card}]", flush=True)
    print(f"time notary audit_periods([1]) (warm, median of 7): "
          f"{audit_ms:.2f} ms; "
          f"{', '.join(f'{k} {v:.2f} ms' for k, v in part_ms.items())} "
          f"(the judge holds verify_period_batch) [{card}]", flush=True)
    print(f"time verify_period_batch(1) (warm, median of 7, one "
          f"keccak_fixed launch and the pull): {verify_ms:.2f} ms; audit "
          f"results and the plain versions' on the card agree [{card}]",
          flush=True)
    print(f"step 14: {time.perf_counter() - t_step:.1f} s in all", flush=True)
    return mods.am, members


# step 15: the port's sharding node (node/backend.py::ShardNode) on the
# card, at config 5's pool, and its CLI
NODE_PERIODS = 2      # cut from 3 so that step 18 fits the smoke's time
NODE_TXS = 33          # a collation: 32 applied transactions, 1 rejected
# what the notary's auditing head and the observer's replaying block launch
NODE_AUDIT = ("agg_g1", "tower", "norm", "finalexp", "keccak_fixed",
              "ecrecover")
NODE_REPLAY = ("replay", "ecrecover", "keccak_fixed")
NODE_KERNELS = ("agg_g1", "tower", "norm", "finalexp", "keccak_fixed",
                "ecrecover", "replay")


def node_devnet(card: str, members) -> None:
    """Step 15a: `tests/torch_node_script.py`'s devnet on the card at
    config 5's pool (100 shards, committee 135, a pool of 135: the notary
    node and 134 members), quorum 1 (each member is sampled for a shard
    with probability 1/135, so at quorum 90 nothing elects and the
    observer would have no canonical collation), windback depth 1, three
    periods of 33-transaction collations on the proposer nodes' shards;
    the members are step 14's (`members`: its account manager and
    accounts, their BLS keys derived there).
    Counted from 0 around the whole run, by block. Fails unless every
    kernel of the path launched, each auditing head ran the audit's
    kernels and each replaying block the replay's, the notary fetched the
    proposers' bodies over the hub (windback checks, bodies stored, no
    error), the notary's canonical headers are the SMC's approved
    records, the
    observer's roots equal the scalar replay's on the host, the journal
    and the mirror hold each period's votes and records, and no node
    recorded an error."""
    from gethsharding_tpu_torch import tracing
    from gethsharding_tpu_torch.ops import _build

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import torch_node_script as script

    m = script.modules("gethsharding_tpu_torch")
    cfg = m.Config(quorum_size=1, windback_depth=1)
    profiled = {}

    def seal_with(number, commit):
        # the last auditing head (period NODE_PERIODS's audit) under the
        # profiler, for its device time and the card's idle share
        if number != (NODE_PERIODS + 1) * cfg.period_length:
            return commit()
        box = []
        by_name, wall_ms = device_times(lambda: box.append(commit()))
        profiled.update(split=kernel_split(by_name), wall_ms=wall_ms)
        return box[0]

    # the services' own spans (notary phases, proposer, txpool) say where
    # a head's host time goes
    from gethsharding_tpu_torch.core import derive_sha as ds
    from gethsharding_tpu_torch.core import state_processor as sp

    routes = lambda: (ds.m_native_roots.value, ds.m_python_roots.value,
                      sp.m_native_state_roots.value,
                      sp.m_python_state_roots.value)
    roots0 = routes()
    tracer = tracing.enable(ring_spans=1 << 16)
    tracer.clear()
    for k in _build.KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    try:
        out = script.run(m, cfg, NOTARY_POOL, NODE_PERIODS,
                         {"sig_backend": "torch"},
                         txs_per_collation=NODE_TXS, min_proposers=4,
                         counts=_build.launch_counts, seal_with=seal_with,
                         members=members, finale=light_finale(script, m))
        torch.cuda.synchronize()
    finally:
        tracing.disable()
    run_s = time.perf_counter() - t0
    chunk_n, chunk_py, state_n, state_py = (
        b - a for a, b in zip(roots0, routes()))
    if not chunk_n or not state_n:
        fail(f"step 15: the native root route built {chunk_n} chunk roots "
             f"and {state_n} state roots ({chunk_py} and {state_py} in "
             f"Python)")
    spans = tracer.recent_spans()
    total = {n: c for n, c in _build.launch_counts().items() if c}
    missing = [k for k in NODE_KERNELS if not total.get(k)]
    if missing:
        fail(f"step 15: the node's run launched no {missing} ({total})")
    layout, chain, nodes = out["layout"], out["chain"], out["nodes"]
    plen = cfg.period_length
    summaries, launches = out["summaries"], out["launches"]
    observer = nodes["observer"].service(m.Observer)
    # the observer's own timer, read before the host twin below adds to it
    replay_timer = (observer.m_replay_latency.count,
                    observer.m_replay_latency.mean() * 1e3)
    by_period = {}
    for period in range(1, NODE_PERIODS + 2):
        blocks = launches.get(period, {}) | launches.get(period - 1, {})
        head = blocks.get(period * plen, {})
        want = NODE_AUDIT if period > 1 else ("ecrecover",)
        if period > NODE_PERIODS:
            want = tuple(k for k in NODE_AUDIT if k != "ecrecover")
        if any(not head.get(k) for k in want) \
                or (period > 1 and (head["agg_g1"], head["finalexp"])
                    != (1, 1)):
            fail(f"step 15: the head of block {period * plen} launched "
                 f"{head}; want {want}")
        if period <= NODE_PERIODS:
            replay = blocks.get(period * plen + 1, {})
            if any(not replay.get(k) for k in NODE_REPLAY) \
                    or replay["replay"] != 1:
                fail(f"step 15: block {period * plen + 1} (the observer's "
                     f"replay) launched {replay}")
        by_period[period] = collections.Counter()
        for number, got in blocks.items():
            if period * plen <= number < (period + 1) * plen:
                by_period[period].update(got)
    last = summaries[NODE_PERIODS + 1]
    errors = {k: v for k, v in last["errors"].items() if v}
    if errors:
        fail(f"step 15: the nodes recorded errors {errors}")
    mine = layout["eligibility"]
    voted = sum(len(mine[p][layout["notary"]])
                for p in range(1, NODE_PERIODS + 1))
    n = last["notary"]
    if (n["votes_submitted"], n["audits_run"], n["audit_mismatches"]) \
            != (voted, NODE_PERIODS, 0) or not last["windback_checks"]:
        fail(f"step 15: the notary's counters {n}, windback checks "
             f"{last['windback_checks']}; want {voted} votes and "
             f"{NODE_PERIODS} clean audits")
    fetched = nodes["notary"].service(m.Syncer).bodies_stored
    notary_kv = nodes["notary"].services[0].db
    for p in range(1, NODE_PERIODS + 1):
        for s in mine[p][layout["notary"]]:
            if not notary_kv.get(bytes(chain.collation_record(s, p)
                                       .chunk_root)):
                fail(f"step 15: the notary holds no body of shard {s} "
                     f"period {p}")
        snap = summaries[p]["mirror"]
        records = {int(k): v for k, v in snap["records"].items()}
        if snap["period"] != p or any(
                records.get(s, {}).get("chunk_root")
                != bytes(chain.collation_record(s, p).chunk_root).hex()
                for s in layout["proposers"]):
            fail(f"step 15: the mirror's snapshot of period {p} lacks "
                 f"its records")
        journaled = {tuple(v) for v in summaries[p]["journal"]["votes"]}
        if any((s, p) not in journaled
               for s in mine[p][layout["notary"]]):
            fail(f"step 15: the journal lacks period {p}'s votes "
                 f"({journaled})")
    if last["journal"]["audit_high_water"] != NODE_PERIODS:
        fail(f"step 15: the journal's audit mark {last['journal']}")
    # the canonical headers a node service wrote: the notary's, for each
    # period it voted its own shard into approval (the observer's header
    # and its body request are the script's, from the SMC's record: no
    # node writes them, in the reference's node neither)
    own = layout["notary_shard"]
    voted_own = [p for p in range(1, NODE_PERIODS + 1)
                 if own in mine[p][layout["notary"]]]
    if not voted_own or n["canonical_set"] != len(voted_own):
        fail(f"step 15: the notary set {n['canonical_set']} canonical "
             f"headers; it voted its own shard {own} in periods "
             f"{voted_own}")
    for p in voted_own:
        rec = chain.collation_record(own, p)
        want = m.CollationHeader(shard_id=own, chunk_root=rec.chunk_root,
                                 period=p, proposer_address=rec.proposer,
                                 proposer_signature=rec.signature)
        if not rec.is_elected or nodes["notary"].shard.canonical_header_hash(
                own, p) != want.hash():
            fail(f"step 15: the notary's canonical header of shard {own} "
                 f"period {p} is not the SMC's")
    canonical = len(voted_own)
    # the observer's roots against the scalar replay on the host
    twin = m.Observer(client=m.SMCClient(backend=m.SimulatedMainchain()),
                      shard=nodes["observer"].shard, replay_engine="python")
    cols = [nodes["observer"].shard.canonical_collation(layout["observer"],
                                                        p)
            for p in range(1, NODE_PERIODS + 1)]
    for p, col in enumerate(cols, start=1):
        if len(col.transactions) < NODE_TXS - 1:
            fail(f"step 15: the observer's collation of period {p} holds "
                 f"{len(col.transactions)} transactions")
        twin.replay_collation(p, col)
    if (twin.state_roots, twin.canonical_roots) != (
            observer.state_roots, observer.canonical_roots):
        fail("step 15: the observer's roots differ from the scalar "
             "replay's")
    # the auditing heads: blocks 2·plen … NODE_PERIODS·plen bare, the
    # last one's (period NODE_PERIODS's audit) under the profiler
    heads = {p * plen: out["block_s"][p * plen] * 1e3
             for p in range(2, NODE_PERIODS + 1)}
    last_head = (NODE_PERIODS + 1) * plen
    replays = [out["block_s"][p * plen + 1] * 1e3
               for p in range(1, NODE_PERIODS + 1)]
    split = profiled.get("split", {})
    busy = sum(split.values())
    txs = sum(len(c.transactions) for c in cols)
    print(f"node devnet (step 15a): config 5's pool (100 shards, committee "
          f"135, 135 members, quorum 1, windback 1), notary at pool index "
          f"{layout['notary']} (own shard {layout['notary_shard']}), "
          f"proposer nodes on shards {layout['proposers']}, observer on "
          f"shard {layout['observer']}; {NODE_PERIODS} periods in "
          f"{run_s:.1f} s; the notary voted {n['votes_submitted']} times, "
          f"audited {n['audits_run']} periods "
          f"({n['aggregate_sigs_verified']} votes verified), "
          f"{last['windback_checks']} windback checks, {fetched} bodies "
          f"fetched over the hub; {canonical} canonical headers written "
          f"by the notary (own shard, periods {voted_own}), the SMC's own; "
          f"the observer's canonical headers and body requests written by "
          f"the script from the SMC's records (no node writes them)",
          flush=True)
    print(f"time node auditing head (the notary's audit of the previous "
          f"period and its votes, every node's head on the commit): blocks "
          f"{', '.join(f'{b} {v:.1f} ms' for b, v in heads.items())}; "
          f"block {last_head} under the profiler: "
          f"{out['block_s'][last_head] * 1e3:.1f} ms with the profiler's "
          f"start and stop, device "
          f"{busy:.2f} ms of {profiled.get('wall_ms', 0):.1f} ms "
          f"({', '.join(f'{k} {v:.2f}' for k, v in sorted(split.items()))}),"
          f" idle share {1 - busy / profiled.get('wall_ms', 1):.3f} "
          f"[{card}]", flush=True)
    print(f"time node observer replay (the block after each period's "
          f"votes): median {statistics.median(replays):.1f} ms a "
          f"collation, {txs} transactions replayed on the card "
          f"({observer.txs_replayed} applied, {observer.txs_rejected} "
          f"rejected), roots equal to the scalar replay's [{card}]",
          flush=True)
    for period, got in sorted(by_period.items()):
        print(f"node launches, period {period}'s blocks: "
              f"{dict(sorted(got.items()))}", flush=True)
    print(f"time node blocks (commit with every node's heads, ms): "
          f"{ {b: round(v * 1e3, 1) for b, v in out['block_s'].items()} } "
          f"[{card}]", flush=True)
    # the notary's phases on the auditing heads' thread, by span name
    notary_ms = collections.defaultdict(list)
    for rec in spans:
        if rec["name"].startswith("notary/"):
            notary_ms[rec["name"]].append(rec["dur_us"] / 1e3)
    print("time node notary spans (count, sum ms, max ms): " + ", ".join(
        f"{k} {len(v)} {sum(v):.1f} {max(v):.1f}"
        for k, v in sorted(notary_ms.items())) + f" [{card}]", flush=True)
    lit = out["finale"]
    print(f"node light (step 15a): a light node (no device) on the hub "
          f"after the last audit: shard {layout['observer']} period "
          f"{NODE_PERIODS}'s body of {lit['light']['body_len']} B proven "
          f"by length, available at 16 draws, 4 samples its bytes "
          f"({lit['light']['samples_verified']} proofs verified, "
          f"{lit['honest_s']:.2f} s); a forger's {lit['forged']} answers "
          f"rejected ({lit['rejected']} proofs), no value returned "
          f"({lit['forged_s']:.2f} s); 0 launches; roots in the run: "
          f"{chunk_n} chunk and {state_n} state roots by the native route, "
          f"{chunk_py} and {state_py} in Python [{card}]", flush=True)
    print(f"time node observer replay_collation (its own timer, mean of "
          f"{replay_timer[0]}): {replay_timer[1]:.1f} ms a collation of "
          f"{NODE_TXS} transactions (the replay's account table recovers "
          f"the senders on the host, twice) [{card}]", flush=True)


# step 15's light node: its forger's body, which no node holds, and the
# seconds a sample waits for a verified answer there
FORGED_BODY = b"a body only the smoke holds, proven by nobody " * 20
FORGER_WAIT_S = 1.0


class Forger:
    """A bare `P2PServer` on the hub answering every `ChunkProofRequest`,
    on a thread of its own, with a tampered proof: one over another body,
    so that it proves another root."""

    def __init__(self, m, hub, ds):
        import threading

        self.m, self.ds = m, ds
        self.p2p = m.P2PServer(hub)
        self.p2p.start()
        self.sub = self.p2p.subscribe(m.ChunkProofRequest)
        self.answered = 0
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._answer, daemon=True)
        self.thread.start()

    def _answer(self):
        fake = FORGED_BODY[::-1]
        while not self.done.is_set():
            msg = self.sub.try_get()
            if msg is None:
                self.done.wait(0.005)
                continue
            req = msg.data
            self.p2p.send(self.m.ChunkProofResponse(
                chunk_root=req.chunk_root, index=req.index,
                proof=tuple(self.ds.chunk_proof(fake, req.index)),
                body_len=len(fake)), msg.peer)
            self.answered += 1

    def close(self):
        self.done.set()
        self.thread.join(timeout=10)
        self.p2p.stop()


def light_finale(script, m):
    """Step 15's finale (`torch_node_script.run(finale=...)`, every node
    still up): a light node (`ShardNode(actor="light")`, no device) joins
    the hub and, counted from 0 around its calls (`launches_aside`),
    proves the observer's last canonical collation (`script.light_check`:
    the proven length, `availability_check(k=16)`, four samples against
    the body's bytes); then a record whose body only the smoke holds, and
    a forger answering every proof request: a sample and an availability
    check there return no value and raise `proofs_rejected`. Fails unless
    every answer is the known one and nothing launched."""
    from gethsharding_tpu_torch.core import derive_sha as ds

    def finale(env):
        t0 = time.perf_counter()
        got, launched = launches_aside(lambda: script.light_check(m, env))
        honest_s = time.perf_counter() - t0
        if launched or got["proven_length"] != got["body_len"] \
                or got["available"] is not True \
                or got["samples"] != got["want"] or got["errors"] \
                or got["proofs_rejected"]:
            fail(f"step 15: the light node gave {got}, launches {launched}")
        # a record of the next period whose body nobody serves
        s, p = env.layout["observer"], env.periods + 1
        root = m.Collation(header=m.CollationHeader(),
                           body=FORGED_BODY).calculate_chunk_root()
        env.chain.add_header(env.nodes["observer"].client.account(), s, p,
                             root)
        forger = Forger(m, env.hub, ds)
        node = script._light_node(m, env, s)
        try:
            light = node.service(m.LightClient)
            t0 = time.perf_counter()
            (forged, avail), launched = launches_aside(lambda: (
                light.sample(s, p, [3], timeout=FORGER_WAIT_S),
                light.availability_check(s, p, k=4,
                                         timeout=FORGER_WAIT_S)))
            forged_s = time.perf_counter() - t0
            rejected = light.proofs_rejected
        finally:
            node.stop()
            forger.close()
        if forged or avail is not False or rejected < 2 or launched \
                or forger.answered < 2:
            fail(f"step 15: against the forger the light node returned "
                 f"{forged}, availability {avail}, {rejected} proofs "
                 f"rejected of {forger.answered}, launches {launched}")
        return {"light": got, "honest_s": honest_s, "forged_s": forged_s,
                "rejected": rejected, "forged": forger.answered}
    return finale


def start_cli(args):
    """Start `python -m gethsharding_tpu_torch.cli *args` in a process of
    its own, its output into a temporary file (it runs beside a devnet),
    and a thread that notes when it exits; returns (command, process, log
    file, start time, exit times)."""
    import tempfile
    import threading

    cmd = [sys.executable, "-m", "gethsharding_tpu_torch.cli", *args]
    out = tempfile.TemporaryFile(mode="w+")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), stdout=out, stderr=subprocess.STDOUT, text=True)
    exited = []
    threading.Thread(target=lambda: (proc.wait(), exited.append(
        time.perf_counter())), daemon=True).start()
    return cmd, proc, out, t0, exited


def finish_cli(started, what: str):
    """Wait for a CLI of `start_cli`: (log, seconds from its start to its
    exit)."""
    cmd, proc, out, t0, exited = started
    try:
        proc.wait(timeout=180)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        fail(f"{what}: the CLI did not exit within 180 s")
    deadline = time.monotonic() + 5.0
    while not exited and time.monotonic() < deadline:
        time.sleep(0.01)
    out.seek(0)
    log = out.read()
    out.close()
    return log, (exited[0] if exited else time.perf_counter()) - t0


def stop_cli(started) -> None:
    """A failed phase: stop its CLI."""
    proc = started[1]
    if proc.poll() is None:
        proc.kill()
        proc.wait()


NODE_CLI = ("sharding", "--actor", "notary", "--deposit", "--runtime", "8",
            "--blocktime", "0.2")


def node_cli(card: str, started) -> None:
    """Step 15b: the port's CLI as a user starts it, in a process of its
    own beside the devnet of step 15a: `python -m gethsharding_tpu_torch.cli
    sharding --actor notary --deposit --runtime 8 --blocktime 0.2`. Fails
    unless it exits 0, logs a sealed period and reports no service
    error."""
    log, wall_s = finish_cli(started, "step 15b")
    sealed = re.findall(r"period \d+ sealed", log)
    if started[1].returncode != 0 or not sealed or "service error" in log:
        fail(f"step 15b: the CLI exited {started[1].returncode}, "
             f"{len(sealed)} periods sealed:\n{log[-3000:]}")
    print(f"node CLI (step 15b): {' '.join(started[0][1:])}: exit 0, "
          f"{len(sealed)} periods sealed, no service error, {wall_s:.1f} s "
          f"from its start to its exit, beside the devnet [{card}]",
          flush=True)


def node_phase(card: str, members) -> None:
    t0 = time.perf_counter()
    cli = start_cli(NODE_CLI)
    try:
        node_devnet(card, members)
        node_cli(card, cli)
    finally:
        stop_cli(cli)
    print(f"step 15: {time.perf_counter() - t0:.1f} s in all", flush=True)


# step 16: the DAS plane on the port's node (`--da-mode sampled`): step
# 15's devnet with every node sampled, once a proof scheme, with hostile
# shards of known answer on the notary's path, and the CLI
DAS_PERIODS = 2
# the devnet's period length, cut from the default 5 so that each hostile
# candidate is checked at 2 voting heads a period, not 4 (a negative
# verdict is not cached, and each check waits out the fetch deadline)
DAS_PLEN = 3
# every hostile kind, each scheme's own in that scheme: a foreign-key
# commitment fails the same way in both schemes, so it runs in merkle
# only; withheld samples run in both (in poly they are the fetch failure
# of `collect_poly_row`), with garbage (a multiproof rejected at
# admission) and merkle-only (a commitment without its polynomial part)
# in poly. At DAS_PLEN both layouts keep a windback call
# (sampled_expected).
DAS_HOSTILE = {"merkle": ("withhold", "garbage", "foreign"),
               "poly": ("withhold", "garbage", "merkle_only")}
# a hostile shard's transaction payload: a body of 44,416 B, k = 11 data
# chunks and n = 17 extended, so that 16 samples are 16 distinct chunks
DAS_PAYLOAD = 43_000
DAS_SAMPLES = 16
# the kernels the sampled notary's batched call launches, by scheme
DAS_KERNELS = {"merkle": ("das_samples",), "poly": ("miller", "finalexp")}
# the nodes' DAS fetch deadline in step 16 (the service's default is 3 s):
# each hostile candidate waits it out at each voting head, while an honest
# fetch lands in 0.06-0.51 s (medians, merkle and poly)
DAS_FETCH_S = 2.0


def _clone(value):
    if isinstance(value, torch.Tensor):
        return value.clone()
    if isinstance(value, tuple):
        return tuple(_clone(v) for v in value)
    return value


class DasCapture:
    """Records, while installed, the sampled notary's DAS calls (the
    backend's `das_verify_samples` / `das_verify_multiproofs`: rows and
    host ms) and the inputs of every kernel launch inside them (the
    sample verifier's planes; the Miller and final-exponentiation
    inputs), cloned, so that each launch can be held against its plain
    version on the same tensors after the run. Launches outside those
    calls (the audit's) are not recorded."""

    def __init__(self):
        from gethsharding_tpu_torch.das import proofs
        from gethsharding_tpu_torch.ops import megakernels as mk
        from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend

        self.inside = False
        self.calls, self.launches = [], []
        self._patches = [(proofs, "verify_planes_kernel", "das_samples"),
                         (mk, "miller_kernel", "miller"),
                         (mk, "finalexp_kernel", "finalexp"),
                         (TorchSigBackend, "das_verify_samples", None),
                         (TorchSigBackend, "das_verify_multiproofs", None)]
        self._saved = [getattr(owner, attr)
                       for owner, attr, _ in self._patches]

    def _kernel(self, name, fn):
        def launch(*args):
            if self.inside:
                self.launches.append((name, _clone(args)))
            return fn(*args)
        return launch

    def _call(self, name, fn):
        def call(backend, *args):
            self.inside = True
            t0 = time.perf_counter()
            try:
                return fn(backend, *args)
            finally:
                self.inside = False
                self.calls.append((name, len(args[0]),
                                   (time.perf_counter() - t0) * 1e3))
        return call

    def __enter__(self):
        for (owner, attr, name), fn in zip(self._patches, self._saved):
            setattr(owner, attr, self._kernel(name, fn) if name
                    else self._call(attr, fn))
        return self

    def __exit__(self, *exc):
        for (owner, attr, _), fn in zip(self._patches, self._saved):
            setattr(owner, attr, fn)


def das_light_finale(script, m, proofs: str):
    """Step 16's finale (every node still up): a light node sampled
    (`da_mode="sampled"`, its DAS service with no store) runs `das_check`
    (`script.das_light_check`) on a proposer's shard and on the withheld
    one of the last period, counted from 0 around it (`launches_aside`):
    True, then False, and nothing launched."""
    def finale(env):
        t0 = time.perf_counter()
        got, launched = launches_aside(lambda: script.das_light_check(m,
                                                                      env))
        if launched or got["honest"] is not True \
                or got.get("withheld") is not False or got["errors"]:
            fail(f"step 16 ({proofs}): the light node's das_check gave "
                 f"{got}, launches {launched}")
        return {**got, "s": time.perf_counter() - t0}
    return finale


def das_devnet(card: str, members, proofs: str) -> dict:
    """Step 16a in one proof scheme: `tests/torch_node_script.py`'s
    devnet at config 5's pool (as step 15: 100 shards, committee 135,
    135 members, quorum 1, windback 1, proposer nodes making
    33-transaction collations), every node `da_mode="sampled"` with
    `da_proofs=proofs`, 16 samples and parity 0.5, a fetch deadline of
    `DAS_FETCH_S`, `DAS_PERIODS` periods,
    and the hostile shards of `DAS_HOSTILE[proofs]` on the notary's path,
    proposed and published by the script. Counted from 0 around the run,
    by block, with the DAS calls captured. Fails unless the notary voted
    on its honest shards only (the SMC's records and its journal), sent
    no body request, scored the known verdicts into the `das/*` counters,
    recorded exactly the hostile errors (no other node an error), and
    each block's head launched the batched kernels the layout gives
    (`sampled_expected`), each launch equal to its plain version on the card
    on the tensors it was given."""
    from gethsharding_tpu_torch import metrics, tracing
    from gethsharding_tpu_torch.das import proofs as das_proofs
    from gethsharding_tpu_torch.ops import _build
    from gethsharding_tpu_torch.ops import megakernels as mk

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import torch_node_script as script

    m = script.modules("gethsharding_tpu_torch")
    cfg = m.Config(quorum_size=1, windback_depth=1, period_length=DAS_PLEN)
    plen = cfg.period_length
    profiled = {}
    profile_block = DAS_PERIODS * plen   # the last period's first head

    def seal_with(number, commit):
        if number != profile_block:
            return commit()
        box = []
        by_name, wall_ms = device_times(lambda: box.append(commit()))
        profiled.update(split=kernel_split(by_name), wall_ms=wall_ms)
        return box[0]

    rejected = {k: metrics.counter(f"das/{k}").value for k in (
        "samples_rejected", "commitments_rejected", "multiproofs_rejected")}
    tracer = tracing.enable(ring_spans=1 << 16)
    tracer.clear()
    for k in _build.KERNELS.values():
        k.launches = 0
    from gethsharding_tpu_torch.das.service import DASService

    init = DASService.__init__
    DASService.__init__ = functools.partialmethod(init,
                                                  fetch_timeout=DAS_FETCH_S)
    t0 = time.perf_counter()
    try:
        with DasCapture() as cap:
            out = script.run(m, cfg, NOTARY_POOL, DAS_PERIODS,
                             {"sig_backend": "torch"},
                             txs_per_collation=NODE_TXS, min_proposers=4,
                             counts=_build.launch_counts,
                             seal_with=seal_with, members=members,
                             da_proofs=proofs, hostile=DAS_HOSTILE[proofs],
                             hostile_payload=DAS_PAYLOAD,
                             finale=das_light_finale(script, m, proofs))
        torch.cuda.synchronize()
    finally:
        tracing.disable()
        DASService.__init__ = init
    run_s = time.perf_counter() - t0
    rejected = {k: metrics.counter(f"das/{k}").value - v
                for k, v in rejected.items()}
    spans = tracer.recent_spans()
    layout, chain, nodes = out["layout"], out["chain"], out["nodes"]
    what = f"step 16 ({proofs})"
    want = script.sampled_expected(layout, plen, DAS_PERIODS)
    bad = layout["hostile"]
    if sorted(bad.values()) != sorted(DAS_HOSTILE[proofs]):
        fail(f"{what}: the hostile shards were placed as {bad}")
    windback = {b: n for b, n in want["calls"].items() if b == 2 * plen}
    if not windback or max(windback.values()) < 2:
        fail(f"{what}: the layout makes no windback call: {want['calls']}")
    me = layout["notary"]
    last = out["summaries"][DAS_PERIODS + 1]
    # the votes: the SMC's records and the notary's journal
    for p in range(1, DAS_PERIODS + 1):
        for s in layout["eligibility"][p][me]:
            voted = me in chain.collation_record(s, p).vote_sigs
            if voted != ((s, p) in want["honest"]):
                fail(f"{what}: the notary's vote on shard {s} period {p} "
                     f"is {voted} in the SMC's record")
    # each period's votes, journaled until the next period's audit
    journaled = sorted(
        (s, p) for p in range(1, DAS_PERIODS + 1)
        for s, q in map(tuple, out["summaries"][p]["journal"]["votes"])
        if q == p)
    n = last["notary"]
    if (n["votes_submitted"], n["canonical_set"], n["audits_run"],
            n["audit_mismatches"]) != (len(want["honest"]), 0, DAS_PERIODS,
                                       0) \
            or journaled != sorted(want["honest"]):
        fail(f"{what}: the notary's counters {n}, journal {journaled}; "
             f"want votes on {want['honest']}, no canonical header (a "
             f"sampled notary holds no body), {DAS_PERIODS} clean audits")
    das = last["das"]
    if das["notary_body_requests"] != 0:
        fail(f"{what}: the sampled notary sent "
             f"{das['notary_body_requests']} body requests")
    if [tuple(v) for v in das["verdicts"]] != want["held"]:
        fail(f"{what}: the verdict cache {das['verdicts']}; want "
             f"{want['held']}")
    # the das/* counters: each honest check fetched and verified its
    # samples (a multiproof each in poly), each hostile check failed
    commitments = {}
    for node in nodes.values():
        if node.das_service is not None:
            commitments.update(node.das_service._commitments)
    width = lambda key: (1 if proofs == "poly"
                         else min(DAS_SAMPLES, commitments[key].n))
    ok_rows = sum(width(key) for key in want["held"])
    bad_rows = sum(width(key) for key in want["hostile"]
                   if bad[key[0]] != "foreign")
    counters = das["counters"]
    fetched = "multiproofs_fetched" if proofs == "poly" else "samples_fetched"
    if (counters[fetched], counters["samples_verified"],
            counters["sample_failures"]) != (ok_rows, ok_rows, bad_rows):
        fail(f"{what}: das counters {counters}; want {ok_rows} fetched and "
             f"verified, {bad_rows} failed")
    garbage_rejected = (rejected["multiproofs_rejected"] if proofs == "poly"
                        else rejected["samples_rejected"])
    if garbage_rejected < sum(1 for key in want["hostile"]
                              if bad[key[0]] == "garbage") \
            or rejected["commitments_rejected"] < sum(
                1 for key in want["hostile"] if bad[key[0]] == "foreign"):
        fail(f"{what}: rejections at admission {rejected}")
    # the errors: the hostile shards' and nothing else
    errors = {k: v for k, v in last["errors"].items() if v}
    expect = {f"collation body unavailable for shard {s} period {p}"
              for s, p in want["hostile"]}
    expect |= {f"rejected DAS commitment for shard {s} period {p}: "
               f"binding/signature check failed"
               for s, p in want["hostile"] if bad[s] == "foreign"}
    if set(errors) != {"notary"} or set(errors["notary"]) != expect:
        fail(f"{what}: the nodes recorded errors {errors}; want {expect}")
    # the launches: each block's batched DAS calls, one launch of each of
    # the scheme's kernels a call (and finalexp's one a poly-mode audit)
    launches = {}
    for blocks in out["launches"].values():
        launches.update(blocks)
    audits = {p * plen for p in range(2, DAS_PERIODS + 2)}
    kernels = DAS_KERNELS[proofs]
    for block in sorted(set(launches) | set(want["calls"])):
        got = launches.get(block, {})
        calls = want["calls"].get(block, 0)
        for k in kernels:
            extra = int(k == "finalexp" and block in audits)
            if got.get(k, 0) != calls + extra:
                fail(f"{what}: block {block} launched {got}; want {calls} "
                     f"batched DAS calls")
    if len(cap.calls) != sum(want["calls"].values()):
        fail(f"{what}: {len(cap.calls)} DAS calls; want {want['calls']}")
    # each launch against its plain version on its own tensors (launches
    # on equal tensors, the hostile rows of a period's later heads, are
    # held once)
    plain = {"das_samples": (das_proofs.verify_planes_kernel,
                             das_proofs.verify_planes_plain),
             "miller": (mk.miller_kernel, mk.run_miller_plain),
             "finalexp": (mk.finalexp_kernel, mk.run_program_plain)}
    held, seen, errs = collections.Counter(), set(), {}
    for name, args in cap.launches:
        flat = [a for a in args if isinstance(a, torch.Tensor)] + [
            t for a in args if isinstance(a, tuple) for t in a]
        key = (name, tuple(hashlib.sha256(t.contiguous().cpu().numpy()
                                          .tobytes()).digest()
                           for t in flat))
        held[name] += 1
        if key in seen:
            continue
        seen.add(key)
        kern, ref = plain[name]
        err = max_abs_err(kern(*args), ref(*args))
        errs[name] = max(errs.get(name, 0), err)
        if err:
            fail(f"{what}: {name} differs from its plain version on the "
                 f"card by {err} on a head's tensors")
    if sorted(held) != sorted(kernels):
        fail(f"{what}: the DAS calls launched {dict(held)}")
    first = {}
    for name, args in cap.launches:
        first.setdefault(name, args)
    kernel_ms = {name: cuda_ms(lambda: plain[name][0](*args), 20)
                 for name, args in first.items()}
    # the report
    heads = {b: out["block_s"][b] * 1e3 for b in sorted(want["calls"])
             if b != profile_block}
    split = profiled.get("split", {})
    busy = sum(split.values())
    span_ms = collections.defaultdict(list)
    for rec in spans:
        if rec["name"].split("/")[0] in ("das", "notary"):
            span_ms[rec["name"]].append(rec["dur_us"] / 1e3)
    # the heads with candidates, whole and without the hostile shards'
    # fetches (each waits out the fetch deadline), and the fetches by kind
    collect = "das/collect_poly" if proofs == "poly" else "das/collect"
    waits, fetch_ms = collections.Counter(), collections.defaultdict(list)
    fetching = set()
    for rec in spans:
        if rec["name"] == collect:
            kind = bad.get(rec["tags"].get("shard"), "honest")
            fetch_ms[kind].append(rec["dur_us"] / 1e3)
            fetching.add(rec["trace"])
            if kind != "honest":
                waits[rec["trace"]] += rec["dur_us"] / 1e3
    voting = [(rec["dur_us"] / 1e3, waits[rec["trace"]]) for rec in spans
              if rec["name"] == "notary/notarize"
              and rec["trace"] in fetching]
    rows = [r for _, r, _ in cap.calls]
    print(f"node devnet sampled, {proofs} (step 16a): config 5's pool "
          f"(100 shards, committee 135, 135 members, quorum 1, windback "
          f"1, period length {plen}, {DAS_SAMPLES} samples, parity 0.5, "
          f"fetch deadline "
          f"{DAS_FETCH_S} s), notary at pool index "
          f"{me} sampled for {dict((p, layout['eligibility'][p][me]) for p in range(1, DAS_PERIODS + 1))}, "
          f"hostile {bad}, proposer nodes {layout['proposers']}; "
          f"{DAS_PERIODS} periods in {run_s:.1f} s; {len(want['honest'])} "
          f"votes (the SMC's records), 0 body requests, verdicts "
          f"{want['held']}, das counters {counters}, rejected at admission "
          f"{rejected}; {len(cap.calls)} batched DAS calls ({rows} rows), "
          f"launches {dict(held)}, {len(seen)} distinct inputs each equal "
          f"to its plain version on the card (max |kernel - plain| "
          f"{errs})", flush=True)
    lit = out["finale"]
    print(f"node light sampled, {proofs} (step 16a): a light node (no "
          f"device, a DAS service with no store) after the last audit: "
          f"das_check True on proposer shard {layout['proposers'][0]}, "
          f"False on the withheld shard, period {DAS_PERIODS} "
          f"({lit['samples_verified']} samples verified, "
          f"{lit['proofs_rejected']} failed), 0 launches, {lit['s']:.2f} s "
          f"[{card}]", flush=True)
    print(f"time node sampled head ({proofs}; every node's head on the "
          f"commit): blocks {', '.join(f'{b} {v:.1f} ms' for b, v in heads.items())}; "
          f"block {profile_block} (candidates, the audit of period "
          f"{DAS_PERIODS - 1}) under the profiler "
          f"{out['block_s'][profile_block] * 1e3:.1f} ms with the "
          f"profiler's start and stop, device {busy:.2f} ms of "
          f"{profiled.get('wall_ms', 0):.1f} ms "
          f"({', '.join(f'{k} {v:.2f}' for k, v in sorted(split.items()))}), "
          f"idle share {1 - busy / profiled.get('wall_ms', 1):.4f} "
          f"[{card}]", flush=True)
    print(f"time node sampled heads with candidates ({proofs}; "
          f"notary/notarize ms, and without the hostile candidates' "
          f"fetches): "
          + ", ".join(f"{whole:.1f} / {whole - wait:.1f}"
                      for whole, wait in voting)
          + "; fetches by kind (count, median ms): "
          + ", ".join(f"{k} {len(v)} {statistics.median(v):.1f}"
                      for k, v in sorted(fetch_ms.items()))
          + f" [{card}]", flush=True)
    print(f"time node sampled spans ({proofs}; count, sum ms, max ms): "
          + ", ".join(f"{k} {len(v)} {sum(v):.1f} {max(v):.1f}"
                      for k, v in sorted(span_ms.items())) + f" [{card}]",
          flush=True)
    print(f"time node sampled DAS calls ({proofs}; rows, host ms): "
          + ", ".join(f"{r} {ms:.1f}" for _, r, ms in cap.calls)
          + f"; kernel ms on a head's tensors (CUDA events, 20 launches): "
          + ", ".join(f"{k} {v:.4f}" for k, v in kernel_ms.items())
          + f" [{card}]", flush=True)
    return {"run_s": run_s, "launches": dict(held), "kernel_ms": kernel_ms}


DAS_CLI = ("sharding", "--actor", "notary", "--deposit", "--da-mode",
           "sampled", "--da-proofs", "poly", "--runtime", "4",
           "--blocktime", "0.2")


def das_cli(card: str, started) -> None:
    """Step 16b: `python -m gethsharding_tpu_torch.cli sharding --actor
    notary --deposit --da-mode sampled --da-proofs poly --runtime 4
    --blocktime 0.2` in a process of its own beside the devnets of step
    16a: exit 0, a sealed period, no service error."""
    log, wall_s = finish_cli(started, "step 16b")
    sealed = re.findall(r"period \d+ sealed", log)
    if started[1].returncode != 0 or not sealed or "service error" in log \
            or "da=sampled/poly" not in log:
        fail(f"step 16b: the CLI exited {started[1].returncode}, "
             f"{len(sealed)} periods sealed:\n{log[-3000:]}")
    print(f"node CLI sampled (step 16b): {' '.join(started[0][1:])}: exit "
          f"0, {len(sealed)} periods sealed, no service error, {wall_s:.1f} "
          f"s from its start to its exit, beside the devnets [{card}]",
          flush=True)


def das_phase(card: str, members) -> None:
    t0 = time.perf_counter()
    cli = start_cli(DAS_CLI)
    try:
        for proofs in ("merkle", "poly"):
            das_devnet(card, members, proofs)
        das_cli(card, cli)
    finally:
        stop_cli(cli)
    print(f"step 16: {time.perf_counter() - t0:.1f} s in all", flush=True)


# step 17: the serving and resilience plane on the card: the coalescing
# tier, the soundness spot-checker, chaos with the breaker's failover, the
# dispatch watchdog, and the node composed with them (and its CLI)
SERVE_COMMITTEE_THREADS = 8
SERVE_RECOVERY_THREADS = 32
SERVE_SAMPLE_THREADS = 32
SPOT_ROWS = 2              # rows re-verified a checked dispatch (phase 2)
CHAOS_ROWS = (2, 3)        # the chaos phase's batch: a True and a False row
CHAOS_VOTES = 8            # ... cut to their first 8 votes (row 3's forged
                           # vote is its 8th), so that the host's checks
                           # and fallbacks cost a pairing a row, not 135 sums
CHAOS_CORRUPT = 3          # dispatches corrupted, then healed
CHAOS_THRESHOLD = 3        # the breaker's consecutive faults to trip
CHAOS_RESET_S = 5.0        # the breaker's open cooldown, on its own clock
WATCHDOG_S = 1.5           # the watchdog's deadline
WATCHDOG_HANG_S = 4.0      # the chaos hang of the watchdog phase
SERVE_PERIODS = 1          # the node devnet of step 17 (cut from 2 for
                           # step 19)


class LaunchThreads:
    """While open, counts each kernel launch by (kernel, thread name) and
    notes a launch off PyTorch's default stream (a wrapper around
    `Kernel.launch`; the kernels' own counters are untouched)."""

    def __init__(self, build):
        self.build = build
        self.by_thread = collections.Counter()
        self.off_default = []

    def __enter__(self):
        import threading

        orig = self._orig = self.build.Kernel.launch
        outer = self

        def launch(kernel, *args):
            name = threading.current_thread().name
            outer.by_thread[(kernel.name, name)] += 1
            if torch.cuda.current_stream() != torch.cuda.default_stream():
                outer.off_default.append((kernel.name, name))
            return orig(kernel, *args)

        self.build.Kernel.launch = launch
        return self

    def __exit__(self, *exc):
        self.build.Kernel.launch = self._orig

    def on(self, prefix: str) -> dict:
        """Launches by kernel on threads whose name starts with `prefix`."""
        out = collections.Counter()
        for (kernel, thread), n in self.by_thread.items():
            if thread.startswith(prefix):
                out[kernel] += n
        return dict(out)


def serve_group(serving, jobs, what: str):
    """One thread a job [(op, columns, kwargs)], released together through
    `serving.submit`: (results, per-request seconds, wall seconds). Fails
    on any request's error."""
    import threading

    results, lat, errors = [None] * len(jobs), [0.0] * len(jobs), []
    barrier = threading.Barrier(len(jobs) + 1)

    def run(i):
        op, cols, kw = jobs[i]
        barrier.wait()
        t0 = time.perf_counter()
        try:
            results[i] = serving.submit(op, *cols, **kw).result(timeout=300)
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(f"{op}: {exc!r}")
        lat[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(jobs))]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        fail(f"step 17: {what}: requests failed or hung: {errors[:3]}")
    return results, lat, wall


def pct(values, q: float) -> float:
    ordered = sorted(values)
    return ordered[min(len(ordered) - 1, int(q * (len(ordered) - 1) + 0.5))]


def launched_from_zero(build) -> dict:
    return {n: c for n, c in build.launch_counts().items() if c}


def coalescing_phase(card, build, period, vote):
    """Step 17.1: 8 threads split step 3's period (keyed, hostile rows
    included), 32 threads recover one of step 10's signatures each, and
    32 threads split its samples, each group through one
    `ServingSigBackend(TorchSigBackend())` at the default `ServingConfig`:
    every request's result is the direct call's, in its row order, in
    fewer dispatches than requests, each committee dispatch one `agg_g1`
    and one `finalexp` (with towers and normalizes), each recovery
    dispatch one `ecrecover`, each sample dispatch one `das_samples`, all
    on the dispatch thread. Returns each group's per-request latency
    (median ms) and the direct call's on one request's rows."""
    from gethsharding_tpu_torch.serving import ServingSigBackend
    from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend

    msgs, sig_rows, pk_rows, keys, want = period
    medians = {}
    (digests, sigs65, want_addr), (chunks, indices, proofs, roots,
                                   want_ok) = vote
    direct = TorchSigBackend()
    serving = ServingSigBackend(TorchSigBackend())
    # both backends' line tables built first: the groups below run warm
    if direct.bls_verify_committees(msgs, sig_rows, pk_rows,
                                    pk_row_keys=keys) != want \
            or serving.bls_verify_committees(msgs, sig_rows, pk_rows,
                                             pk_row_keys=keys) != want:
        fail("step 17: the period's verdicts (direct or served) are not "
             "the expected list")
    k = SERVE_COMMITTEE_THREADS
    cuts = [round(i * SHARDS / k) for i in range(k + 1)]
    groups = {
        "committees": [("bls_verify_committees",
                        (msgs[a:b], sig_rows[a:b], pk_rows[a:b]),
                        {"pk_row_keys": keys[a:b]})
                       for a, b in zip(cuts, cuts[1:])],
        "recoveries": [("ecrecover_addresses", ([digests[i]], [sigs65[i]]),
                        {}) for i in range(SERVE_RECOVERY_THREADS)],
        "samples": [],
    }
    n_smp = len(chunks)
    scuts = [round(i * n_smp / SERVE_SAMPLE_THREADS)
             for i in range(SERVE_SAMPLE_THREADS + 1)]
    groups["samples"] = [("das_verify_samples",
                          (chunks[a:b], indices[a:b], proofs[a:b],
                           roots[a:b]), {})
                         for a, b in zip(scuts, scuts[1:])]
    expected = {
        "committees": [want[a:b] for a, b in zip(cuts, cuts[1:])],
        "recoveries": [[want_addr[i]] for i in range(SERVE_RECOVERY_THREADS)],
        "samples": [want_ok[a:b] for a, b in zip(scuts, scuts[1:])],
    }
    kernel_of = {"committees": ("bls_verify_committees", "finalexp"),
                 "recoveries": ("ecrecover_addresses", "ecrecover"),
                 "samples": ("das_verify_samples", "das_samples")}
    # the direct call's latency: the whole batch, and one request's rows
    direct_ms = {
        "committees": host_ms(lambda: direct.bls_verify_committees(
            msgs, sig_rows, pk_rows, pk_row_keys=keys), 3),
        "recoveries": host_ms(lambda: direct.ecrecover_addresses(
            digests[:SERVE_RECOVERY_THREADS],
            sigs65[:SERVE_RECOVERY_THREADS]), 3),
        "samples": host_ms(lambda: direct.das_verify_samples(
            chunks, indices, proofs, roots), 3)}
    one_ms = {name: host_ms(lambda: getattr(direct, jobs[0][0])(
        *jobs[0][1], **jobs[0][2]), 3) for name, jobs in groups.items()}
    for name, jobs in groups.items():
        op, kernel = kernel_of[name]
        d0 = dict(serving.batcher.dispatch_counts)
        for kern in build.KERNELS.values():
            kern.launches = 0
        with LaunchThreads(build) as threads:
            got, lat, wall = serve_group(serving, jobs, name)
        dispatches = serving.batcher.dispatch_counts[op] - d0[op]
        launched = launched_from_zero(build)
        if got != expected[name]:
            bad = [i for i, (g, w) in enumerate(zip(got, expected[name]))
                   if g != w]
            fail(f"step 17: served {name} differ from the direct call's at "
                 f"requests {bad}")
        if not 1 <= dispatches < len(jobs):
            fail(f"step 17: {name}: {dispatches} dispatches for "
                 f"{len(jobs)} requests")
        want_launched = {kernel: dispatches}
        if name == "committees":
            want_launched["agg_g1"] = dispatches
            if not launched.get("tower") or not launched.get("norm"):
                fail(f"step 17: committee dispatches launched {launched}")
            extra = {k: v for k, v in launched.items()
                     if k not in ("agg_g1", "finalexp", "tower", "norm")}
        else:
            extra = {k: v for k, v in launched.items() if k != kernel}
        if any(launched.get(k) != v for k, v in want_launched.items()) \
                or extra:
            fail(f"step 17: {name}: {dispatches} dispatches launched "
                 f"{launched}")
        if threads.on("serving-dispatch") != launched \
                or threads.off_default:
            fail(f"step 17: {name}: launches off the dispatch thread or "
                 f"its default stream: {dict(threads.by_thread)}, "
                 f"{threads.off_default}")
        rows = sum(len(j[1][0]) for j in jobs)
        lat_ms = [v * 1e3 for v in lat]
        medians[name] = (statistics.median(lat_ms), one_ms[name])
        print(f"serving {name} (step 17.1): {len(jobs)} requests of "
              f"{rows} rows in {dispatches} dispatches "
              f"({rows / dispatches:.1f} rows a dispatch), launches "
              f"{dict(sorted(launched.items()))} on the dispatch thread; "
              f"per-request latency median {statistics.median(lat_ms):.2f} "
              f"ms, p99 {pct(lat_ms, 0.99):.2f} ms, the group "
              f"{wall * 1e3:.1f} ms; the direct call: all {rows} rows "
              f"{direct_ms[name]:.2f} ms, one request's rows "
              f"{one_ms[name]:.2f} ms [{card}]", flush=True)
    jobs = groups["committees"]
    by_name, wall_ms = device_times(
        lambda: serve_group(serving, jobs, "committees, profiled"))
    split = kernel_split(by_name)
    busy = sum(split.values())
    print(f"time serving committees under the profiler (8 requests, "
          f"coalesced): device {busy:.2f} ms of {wall_ms:.1f} ms "
          f"({', '.join(f'{k} {v:.2f}' for k, v in sorted(split.items()))}),"
          f" idle share {1 - busy / wall_ms:.3f} [{card}]", flush=True)
    serving.close()
    return medians


class TimedReference:
    """The spot-checker's scalar reference with its host time by op."""

    def __init__(self, inner):
        self.inner, self.name = inner, inner.name
        self.spent = collections.defaultdict(lambda: [0, 0.0])

    def __getattr__(self, op):
        fn = getattr(self.inner, op)

        def timed(*cols, **kw):
            t0 = time.perf_counter()
            out = fn(*cols, **kw)
            self.spent[op][0] += len(cols[0])
            self.spent[op][1] += time.perf_counter() - t0
            return out

        return timed


def soundness_phase(card, period, vote, poly_rows):
    """Step 17.2: `SpotCheckSigBackend` over the serving tier at rate 1
    with SPOT_ROWS rows, on a few dispatches of every op, on a clean card:
    checks on each op, no mismatch and no invariant violation; the host
    time of a checked row by op."""
    from gethsharding_tpu_torch import metrics
    from gethsharding_tpu_torch.crypto import bn256 as bls
    from gethsharding_tpu_torch.resilience.soundness import (
        SpotCheckSigBackend)
    from gethsharding_tpu_torch.serving import ServingSigBackend
    from gethsharding_tpu_torch.sigbackend import PythonSigBackend
    from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend

    msgs, sig_rows, pk_rows, keys, want = period
    (digests, sigs65, want_addr), (chunks, indices, proofs, roots,
                                   want_ok) = vote
    registry = metrics.Registry()
    reference = TimedReference(PythonSigBackend())
    serving = ServingSigBackend(TorchSigBackend())
    spot = SpotCheckSigBackend(serving, rate=1.0, rows=SPOT_ROWS, seed=17,
                               reference=reference, registry=registry)
    rows4 = slice(0, 4)
    agg = aggregate_votes(bls, msgs[rows4], sig_rows[rows4], pk_rows[rows4],
                          want[rows4])
    cases = [
        ("bls_verify_committees", lambda: spot.bls_verify_committees(
            msgs[:6], sig_rows[:6], pk_rows[:6], pk_row_keys=keys[:6]),
         want[:6]),
        ("bls_verify_committees", lambda: spot.bls_verify_committees_async(
            msgs[2:6], sig_rows[2:6], pk_rows[2:6],
            pk_row_keys=keys[2:6]).result(), want[2:6]),
        ("bls_verify_aggregates", lambda: spot.bls_verify_aggregates(
            *agg[:3]), agg[3]),
        ("das_verify_multiproofs", lambda: spot.das_verify_multiproofs(
            *poly_rows[0]), poly_rows[1]),
    ]
    for i in range(3):
        cut = slice(i * 30, i * 30 + 30)
        cases.append(("ecrecover_addresses", lambda cut=cut:
                      spot.ecrecover_addresses(digests[cut], sigs65[cut]),
                      want_addr[cut]))
        cases.append(("das_verify_samples", lambda cut=cut:
                      spot.submit("das_verify_samples", chunks[cut],
                                  indices[cut], proofs[cut],
                                  roots[cut]).result(), want_ok[cut]))
    for op, call, expect in cases:
        if call() != expect:
            fail(f"step 17: the spot-checked {op} gave other verdicts")
    serving.close()
    per_op = {}
    for op in {c[0] for c in cases}:
        base = f"resilience/soundness/{op}"
        checks, mism, inv = (registry.counter(f"{base}/{k}").value for k in
                             ("checks", "mismatches", "invariant_violations"))
        if not checks or mism or inv:
            fail(f"step 17: soundness on a clean card: {op} checks "
                 f"{checks}, mismatches {mism}, invariant violations {inv}")
        rows, spent = reference.spent[op]
        per_op[op] = (checks, rows, spent * 1e3 / rows)
    print("soundness on a clean card (step 17.2, rate 1, "
          f"{SPOT_ROWS} rows a check): " + ", ".join(
              f"{op} {c} checks of {r} rows, {ms:.1f} ms host a row"
              for op, (c, r, ms) in sorted(per_op.items()))
          + f"; mismatches 0, invariant violations 0 [{card}]", flush=True)


def chaos_phase(card, build, period):
    """Step 17.3: `failover-serving-torch` with the spot-checker (rate 1,
    every row of the batch), the serving tier's backend behind
    `backend.bls_verify_committees:mode=corrupt` for its first
    CHAOS_CORRUPT calls: the breaker trips within `dispatches_to_detect`'s
    budget, calls while open give the expected verdicts from the host,
    the half-open probe recomputes on the card and re-closes; the
    fallbacks, faults and trips are exactly the schedule's."""
    from gethsharding_tpu_torch import metrics
    from gethsharding_tpu_torch.resilience.breaker import (
        CircuitBreaker, FailoverSigBackend)
    from gethsharding_tpu_torch.resilience.chaos import (ChaosSigBackend,
                                                         parse_spec)
    from gethsharding_tpu_torch.resilience.soundness import (
        SpotCheckSigBackend, dispatches_to_detect)
    from gethsharding_tpu_torch.serving import ServingSigBackend
    from gethsharding_tpu_torch.sigbackend import PythonSigBackend
    from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend

    msgs, sig_rows, pk_rows, keys, want = period
    pick = list(CHAOS_ROWS)
    batch = ([msgs[i] for i in pick],
             [sig_rows[i][:CHAOS_VOTES] for i in pick],
             [pk_rows[i][:CHAOS_VOTES] for i in pick])
    # keys of their own: a key names its committee's pubkey row
    bkeys = [("chaos", CHAOS_VOTES) + tuple(keys[i]) for i in pick]
    expect = [want[i] for i in pick]
    if sorted(expect) != [False, True]:
        fail(f"step 17: the chaos batch's rows {pick} are not one True and "
             f"one False")
    schedule = parse_spec(
        f"seed=20,backend.bls_verify_committees:mode=corrupt,"
        f"backend.bls_verify_committees={CHAOS_CORRUPT}")
    registry = metrics.Registry()
    serving = ServingSigBackend(ChaosSigBackend(TorchSigBackend(), schedule),
                                registry=registry)
    spot = SpotCheckSigBackend(serving, rate=1.0, rows=len(pick), seed=20,
                               registry=registry)
    # the breaker's clock is the phase's: the cooldown passes where the
    # phase says, whatever the host's pace of the calls before it
    clock = [0.0]
    breaker = CircuitBreaker(name="chaos", fault_threshold=CHAOS_THRESHOLD,
                             reset_s=CHAOS_RESET_S, registry=registry,
                             clock=lambda: clock[0])
    backend = FailoverSigBackend(spot, PythonSigBackend(), breaker=breaker,
                                 registry=registry)
    per_fault = dispatches_to_detect(1.0, len(pick), len(pick))
    budget = CHAOS_THRESHOLD * per_fault
    timeline, t_start = [], time.perf_counter()
    trip_at = None
    for call in range(CHAOS_THRESHOLD + 4):
        if call == CHAOS_THRESHOLD + 1:
            # past the cooldown: the next call is the half-open probe
            clock[0] += CHAOS_RESET_S
        before = breaker.state_name
        d0 = serving.batcher.dispatch_counts["bls_verify_committees"]
        for kern in build.KERNELS.values():
            kern.launches = 0
        t0 = time.perf_counter()
        got = backend.bls_verify_committees(*batch, pk_row_keys=bkeys)
        ms = (time.perf_counter() - t0) * 1e3
        on_card = build.launch_counts()["finalexp"]
        dispatched = (serving.batcher.dispatch_counts["bls_verify_committees"]
                      - d0)
        after = breaker.state_name
        if before == "closed" and after == "open":
            trip_at = call + 1
        timeline.append((round(t0 - t_start, 2), before, after, got,
                         dispatched, on_card, round(ms, 1)))
        if got != expect:
            fail(f"step 17: call {call + 1} under chaos gave {got}, want "
                 f"{expect}")
    c = lambda name: registry.counter(
        f"resilience/breaker/chaos/{name}").value
    mism = registry.counter(
        "resilience/soundness/bls_verify_committees/mismatches").value
    states = [(b, a) for _, b, a, *_ in timeline]
    want_states = ([("closed", "closed")] * (CHAOS_THRESHOLD - 1)
                   + [("closed", "open"), ("open", "open"),
                      ("open", "closed"), ("closed", "closed"),
                      ("closed", "closed")])
    if trip_at is None or trip_at > budget or states != want_states:
        fail(f"step 17: breaker timeline {timeline}; tripped at call "
             f"{trip_at}, budget {budget}")
    probe = timeline[CHAOS_THRESHOLD + 1]
    if probe[5] != 1 or timeline[CHAOS_THRESHOLD][5] != 0 \
            or timeline[-1][5] != 1:
        fail(f"step 17: the probe or the closed calls did not run on the "
             f"card, the open call did: {timeline}")
    if (c("trips"), c("primary_faults"), c("fallback_calls"), c("probes"),
            c("closes"), c("probe_mismatches"), mism) != (
                1, CHAOS_CORRUPT, CHAOS_CORRUPT + 1, 1, 1, 0,
                CHAOS_CORRUPT) \
            or schedule.injected != {"backend.bls_verify_committees":
                                     CHAOS_CORRUPT}:
        fail(f"step 17: trips {c('trips')}, faults {c('primary_faults')}, "
             f"fallbacks {c('fallback_calls')}, probes {c('probes')}, "
             f"closes {c('closes')}, mismatches {mism}, injected "
             f"{schedule.injected}")
    serving.close()
    print(f"chaos, breaker and failover (step 17.3): rows {pick} (their "
          f"first {CHAOS_VOTES} votes), `backend.bls_verify_committees:mode=corrupt` for "
          f"{CHAOS_CORRUPT} dispatches, spot-check rate 1 of "
          f"{len(pick)} rows, threshold {CHAOS_THRESHOLD}, cooldown "
          f"{CHAOS_RESET_S} s on the breaker's clock: tripped at call {trip_at} (budget {budget}: "
          f"{CHAOS_THRESHOLD} faults × {per_fault} dispatch to detect at "
          f"99%); 1 trip, {CHAOS_CORRUPT} faults, {CHAOS_CORRUPT + 1} "
          f"fallbacks, 1 probe on the card, 1 close. Timeline (s from "
          f"start, state before -> after, verdicts, dispatches, finalexp "
          f"launches, ms): {timeline} [{card}]", flush=True)


def watchdog_phase(card, build, period):
    """Step 17.4: `dispatch.bls_verify_committees` hangs the serving
    dispatch thread WATCHDOG_HANG_S s under a watchdog of WATCHDOG_S s:
    the hung batch fails with `DeadlineExceeded`, the next batches are
    served on the card by a fresh dispatch thread with the expected
    verdicts, and once the stale thread's late call returns, both
    threads' verdicts equal the expected list."""
    import threading

    from gethsharding_tpu_torch import metrics
    from gethsharding_tpu_torch.resilience.chaos import (ChaosSigBackend,
                                                         parse_spec)
    from gethsharding_tpu_torch.resilience.errors import DeadlineExceeded
    from gethsharding_tpu_torch.serving import ServingConfig, ServingSigBackend
    from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend

    msgs, sig_rows, pk_rows, keys, want = period
    calls = []     # (thread ident, verdicts) of every call the card ran

    class Recorded(TorchSigBackend):
        def bls_verify_committees_async(self, *args, **kw):
            out = super().bls_verify_committees_async(*args, **kw).result()
            calls.append((threading.get_ident(), out))
            return VerdictDone(out)

    class VerdictDone:
        def __init__(self, out):
            self.out = out

        def result(self, timeout=None):
            return self.out

    rows = slice(0, 12)
    batch = (msgs[rows], sig_rows[rows], pk_rows[rows])
    bkeys, expect = keys[rows], want[rows]
    inner = Recorded()
    inner.bls_verify_committees(*batch, pk_row_keys=bkeys)   # warm tables
    calls.clear()
    schedule = parse_spec("seed=21,dispatch.bls_verify_committees=1")
    registry = metrics.Registry()
    serving = ServingSigBackend(
        ChaosSigBackend(inner, schedule, hang_s=WATCHDOG_HANG_S),
        ServingConfig(watchdog_s=WATCHDOG_S), registry=registry)
    t0 = time.perf_counter()
    try:
        serving.bls_verify_committees(*batch, pk_row_keys=bkeys)
        fail("step 17: the hung batch did not fail")
    except DeadlineExceeded:
        failed_s = time.perf_counter() - t0
    served = 0
    while len({t for t, _ in calls}) < 2 or served < 2:
        if time.perf_counter() - t0 > WATCHDOG_HANG_S + 30:
            fail(f"step 17: the stale thread's call never returned "
                 f"({len(calls)} calls)")
        if serving.bls_verify_committees(*batch,
                                         pk_row_keys=bkeys) != expect:
            fail("step 17: a batch after the watchdog's restart gave "
                 "other verdicts")
        served += 1
    serving.close()
    threads = {t for t, _ in calls}
    if len(threads) != 2 or any(out != expect for _, out in calls) \
            or registry.counter("resilience/watchdog/timeouts").value != 1:
        fail(f"step 17: watchdog: {len(threads)} dispatch threads, "
             f"verdicts {[out == expect for _, out in calls]}, timeouts "
             f"{registry.counter('resilience/watchdog/timeouts').value}")
    print(f"watchdog (step 17.4): a {WATCHDOG_HANG_S:.0f} s chaos hang of "
          f"the dispatch thread under a {WATCHDOG_S} s deadline: the hung "
          f"batch failed with DeadlineExceeded after {failed_s:.2f} s, "
          f"{served} batches served on the card by the fresh dispatch "
          f"thread meanwhile, the stale thread's late call then returned; "
          f"{len(calls)} calls on 2 threads, every verdict the expected "
          f"list [{card}]", flush=True)


def serving_node_devnet(card, build, members) -> None:
    """Step 17.5a: step 15's devnet cut to SERVE_PERIODS periods, every
    node composed `failover-torch` over soundness (rate 1, one row) over
    the serving tier: the notary's votes are the SMC's records and its
    journal's, its audit, recovery and the proposers' txpool recoveries
    launch on the serving dispatch threads, primary calls equal the
    serving requests and the launches their dispatches, the breakers stay
    closed with 0 fallbacks and 0 spot-check mismatches, no node error."""
    from gethsharding_tpu_torch import metrics

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    import torch_node_script as script

    m = script.modules("gethsharding_tpu_torch")
    cfg = m.Config(quorum_size=1, windback_depth=1)
    os.environ["GETHSHARDING_TORCH_SOUNDNESS_ROWS"] = "1"
    reg = metrics.DEFAULT_REGISTRY
    value = lambda name: getattr(reg.get(name), "value", 0)
    names = ["resilience/breaker/sigbackend/" + k for k in (
        "trips", "fallback_calls", "primary_calls", "primary_faults")]
    names += [f"serving/{k}/{w}" for k in ("ecrecover", "bls_committee",
                                           "bls_aggregate", "das_verify",
                                           "das_poly_verify")
              for w in ("requests", "dispatches")]
    names += [f"resilience/soundness/{op}/{w}" for op in (
        "ecrecover_addresses", "bls_verify_committees")
        for w in ("checks", "mismatches", "invariant_violations")]
    before = {k: value(k) for k in names}
    for kern in build.KERNELS.values():
        kern.launches = 0
    t0 = time.perf_counter()
    try:
        with LaunchThreads(build) as threads:
            out = script.run(m, cfg, NOTARY_POOL, SERVE_PERIODS,
                             {"sig_backend": "failover-torch",
                              "serving": True, "soundness_rate": 1.0},
                             txs_per_collation=NODE_TXS, min_proposers=4,
                             counts=build.launch_counts, members=members)
            torch.cuda.synchronize()
    finally:
        del os.environ["GETHSHARDING_TORCH_SOUNDNESS_ROWS"]
    run_s = time.perf_counter() - t0
    d = {k: value(k) - before[k] for k in names}
    layout, chain, nodes = out["layout"], out["chain"], out["nodes"]
    last = out["summaries"][SERVE_PERIODS + 1]
    errors = {k: v for k, v in last["errors"].items() if v}
    if errors:
        fail(f"step 17: the serving nodes recorded errors {errors}")
    mine = layout["eligibility"]
    voted = sum(len(mine[p][layout["notary"]])
                for p in range(1, SERVE_PERIODS + 1))
    n = last["notary"]
    if (n["votes_submitted"], n["audits_run"], n["audit_mismatches"]) \
            != (voted, SERVE_PERIODS, 0):
        fail(f"step 17: the serving notary's counters {n}; want {voted} "
             f"votes and {SERVE_PERIODS} clean audits")
    for p in range(1, SERVE_PERIODS + 1):
        journaled = {tuple(v) for v in out["summaries"][p]["journal"]
                     ["votes"]}
        for s in mine[p][layout["notary"]]:
            rec = chain.collation_record(s, p)
            if (s, p) not in journaled or not rec.vote_count:
                fail(f"step 17: the notary's vote on shard {s} period {p} "
                     f"is not the SMC's record or its journal's")
    served = threads.on("serving-dispatch")
    for kernel in ("agg_g1", "tower", "norm", "finalexp", "ecrecover"):
        if not served.get(kernel):
            fail(f"step 17: the serving dispatch threads launched no "
                 f"{kernel}: {dict(threads.by_thread)}")
    if threads.off_default:
        fail(f"step 17: launches off the default stream "
             f"{threads.off_default[:4]}")
    proposers = [node for name, node in nodes.items()
                 if name.startswith("proposer")]
    recovered = sum(node.sig_backend.primary.inner.batcher.dispatch_counts
                    ["ecrecover_addresses"] for node in proposers)
    requests = sum(d[f"serving/{k}/requests"] for k in (
        "ecrecover", "bls_committee", "bls_aggregate", "das_verify",
        "das_poly_verify"))
    if not recovered \
            or served.get("ecrecover") != d["serving/ecrecover/dispatches"] \
            or served.get("finalexp") != d[
                "serving/bls_committee/dispatches"] \
            or served.get("agg_g1") != d["serving/bls_committee/dispatches"] \
            or d["resilience/breaker/sigbackend/primary_calls"] != requests:
        fail(f"step 17: launches on the dispatch threads {served}, "
             f"counters {d}, proposer recovery dispatches {recovered}")
    if d["resilience/breaker/sigbackend/trips"] \
            or d["resilience/breaker/sigbackend/fallback_calls"] \
            or d["resilience/breaker/sigbackend/primary_faults"] \
            or any(node.sig_backend.breaker.state_name != "closed"
                   for node in nodes.values()):
        fail(f"step 17: a breaker tripped or fell back: {d}")
    for op in ("ecrecover_addresses", "bls_verify_committees"):
        base = f"resilience/soundness/{op}"
        if not d[f"{base}/checks"] or d[f"{base}/mismatches"] \
                or d[f"{base}/invariant_violations"]:
            fail(f"step 17: the node's spot-checks of {op}: {d}")
    on_main = {k: v for (k, t), v in threads.by_thread.items()
               if not t.startswith("serving-dispatch")}
    print(f"serving node devnet (step 17.5a): step 15's devnet cut to "
          f"{SERVE_PERIODS} periods, every node failover+soundness(rate 1, "
          f"1 row)+serving+torch; {SERVE_PERIODS} periods in {run_s:.1f} s; "
          f"the notary voted {n['votes_submitted']} times (the SMC's "
          f"records), audited {n['audits_run']} periods; serving requests "
          f"{requests} = primary calls, dispatches: committees "
          f"{d['serving/bls_committee/dispatches']}, recoveries "
          f"{d['serving/ecrecover/dispatches']} ({recovered} of them the "
          f"proposers' txpools); launches on the dispatch threads "
          f"{dict(sorted(served.items()))}, elsewhere (the judge's and the "
          f"observer's replays) {on_main}; spot-checks "
          f"{d['resilience/soundness/ecrecover_addresses/checks']} "
          f"recoveries and "
          f"{d['resilience/soundness/bls_verify_committees/checks']} "
          f"committees, 0 mismatches; breakers closed, 0 fallbacks, 0 "
          f"trips [{card}]", flush=True)
    print(f"time serving node blocks (ms): "
          f"{ {b: round(v * 1e3, 1) for b, v in out['block_s'].items()} } "
          f"[{card}]", flush=True)


def start_serving_cli():
    """Start step 17.5b's CLI in a process of its own (it runs beside the
    devnet of step 17.5a); returns (command, process, start time)."""
    cmd = [sys.executable, "-m", "gethsharding_tpu_torch.cli", "sharding",
           "--actor", "notary", "--deposit", "--serving",
           "--soundness-rate", "0.05", "--sigbackend", "failover-torch",
           "--runtime", "8", "--blocktime", "0.2"]
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    return cmd, proc, time.perf_counter()


def serving_cli(card: str, started) -> None:
    """Step 17.5b: `python -m gethsharding_tpu_torch.cli sharding --actor
    notary --deposit --serving --soundness-rate 0.05 --sigbackend
    failover-torch --runtime 8 --blocktime 0.2` in a process of its own
    (`start_serving_cli`): exit 0, a sealed period, no service error, and
    the breaker's exit summary clean: 0 primary faults, 0 fallback calls,
    0 trips, the breaker closed, no fault line, primary calls equal to the
    serving requests, and each op's dispatches equal to its kernel's
    launches. The CLI's lone
    notary has no proposer beside it, so it has nothing to vote on and may
    make no device call: this step holds the CLI's flags and composition;
    step 17.5a holds the composed node on the card."""
    cmd, proc, t0 = started
    try:
        log, _ = proc.communicate(timeout=180)
    except subprocess.TimeoutExpired:
        fail("step 17.5b: the CLI did not exit within 180 s")
    wall_s = time.perf_counter() - t0
    sealed = re.findall(r"period \d+ sealed", log)
    found = re.search(r"sigbackend failover\+soundness\+serving\+torch at "
                      r"exit: (\{.*\})", log)
    if proc.returncode != 0 or not sealed or "service error" in log \
            or "primary sigbackend" in log or not found:
        fail(f"step 17.5b: the CLI exited {proc.returncode}, {len(sealed)} "
             f"periods sealed:\n{log[-3000:]}")
    summary = json.loads(found.group(1))
    serving, launches = summary["serving"], summary["launches"]
    requests = sum(r for r, _ in serving.values())
    # the kernel each op's dispatch launches once
    heads = {"ecrecover": "ecrecover", "bls_committee": "agg_g1",
             "das_verify": "das_samples"}
    if summary["primary_faults"] or summary["fallback_calls"] \
            or summary["trips"] or summary["state"] != "closed" \
            or summary["primary_calls"] != requests \
            or any(serving[op][1] != launches.get(k, 0)
                   for op, k in heads.items()) \
            or (summary["primary_calls"] and not launches):
        fail(f"step 17.5b: the CLI's breaker summary {summary}")
    print(f"node CLI serving (step 17.5b): {' '.join(cmd[1:])}: exit 0, "
          f"{len(sealed)} periods sealed, no service error; at exit "
          f"{summary['primary_calls']} primary calls (the lone notary has "
          f"no proposer's header to vote on), 0 faults, 0 fallbacks, 0 "
          f"trips, breaker closed, launches {launches}; {wall_s:.1f} s "
          f"with its start, beside the devnet [{card}]", flush=True)


def serving_phase(card: str, seed: int, period, members):
    """Step 17: the serving and resilience plane on the card (its five
    phases above), timed. Returns step 10's vote rows and the coalescing
    phase's per-request medians, which step 18 reuses."""
    from gethsharding_tpu_torch.crypto import secp256k1 as ecdsa
    from gethsharding_tpu_torch.crypto.keccak import keccak256
    from gethsharding_tpu_torch.das import pcs
    from gethsharding_tpu_torch.das import proofs as das
    from gethsharding_tpu_torch.ops import _build

    t_step = time.perf_counter()
    vote = vote_period(ecdsa, das, keccak256, seed)   # step 10's
    # one honest multiproof row (the dev SRS is step 11's): its host check
    # costs ~1.4 s
    rows = poly_period(pcs, seed, 1)
    poly = ([list(col) for col in zip(*rows)], [True])
    marks = [("made", time.perf_counter())]
    medians = coalescing_phase(card, _build, period, vote)
    marks.append(("coalescing", time.perf_counter()))
    soundness_phase(card, period, vote, poly)
    marks.append(("soundness", time.perf_counter()))
    chaos_phase(card, _build, period)
    marks.append(("chaos", time.perf_counter()))
    watchdog_phase(card, _build, period)
    marks.append(("watchdog", time.perf_counter()))
    cli = start_serving_cli()
    try:
        serving_node_devnet(card, _build, members)
        marks.append(("node", time.perf_counter()))
        serving_cli(card, cli)
        marks.append(("cli after it", time.perf_counter()))
    finally:
        if cli[1].poll() is None:     # a failed phase: stop the CLI
            cli[1].kill()
            cli[1].wait()
    prev, parts = t_step, []
    for name, t in marks:
        parts.append(f"{name} {t - prev:.1f}")
        prev = t
    print(f"step 17: {time.perf_counter() - t_step:.1f} s in all "
          f"({', '.join(parts)} s)", flush=True)
    return vote, medians


# step 18: the cross-process topology on the card: a chain process serving
# the verifications to remote callers, and a devnet of OS processes
TOPO_THREADS = 8                # client threads, each on its own RPCClient
TOPO_RECOVERIES = 32            # single shard_ecrecover calls
TOPO_KERNELS = ("agg_g1", "tower", "norm", "finalexp", "ecrecover",
                "das_samples", "keccak_fixed")
DEVNET_NOTARY = ("agg_g1", "finalexp", "tower", "norm", "ecrecover")
CHAIN_ARGS = ("--sigbackend", "torch", "--quorum", "1", "--runtime", "600")
DEVNET_CMD = ("devnet", "--notaries", "1", "--proposers", "2",
              "--observers", "1", "--lights", "1", "--quorum", "1",
              "--shardcount", "2", "--sigbackend", "torch", "--blocktime",
              "0.2", "--interval", "0.5")
DEVNET_RUNTIME_S = 300          # the devnet's own limit; stopped earlier
# the votes the notary may lose to the chain sealing their period while
# they are in flight, per vote it cast, over both of its lives: at 1 s
# periods a header added late in its period leaves its vote no time (on
# the H100: 2 missed beside 4 cast in one run, 4 missed in another); a
# notary whose votes miss as a rule loses far more
DEVNET_MISSED_PER_VOTE = 2
DEVNET_WAIT_S = 150             # the longest wait on one devnet event


def read_line(proc, timeout: float, what: str) -> str:
    """The next stdout line of `proc`, or fail after `timeout` s."""
    import selectors

    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    try:
        if not sel.select(timeout=timeout):
            fail(f"step 18: {what}: no line within {timeout:.0f} s")
        line = proc.stdout.readline()
    finally:
        sel.close()
    if not line:
        fail(f"step 18: {what}: the process exited ({proc.poll()})")
    return line


def stop_child(proc, sig=signal.SIGINT, timeout: float = 60.0) -> None:
    """Stop a child as an operator does; kill it past `timeout`."""
    if proc.poll() is None:
        proc.send_signal(sig)
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def exit_line(log: str, prefix: str) -> dict:
    found = re.findall(re.escape(prefix) + r" (\{.*\})", log)
    if not found:
        fail(f"step 18: no '{prefix}' line in:\n{log[-3000:]}")
    return json.loads(found[-1])


def topology_jobs(period, vote, codec):
    """Step 18.1's requests, as (op label, method, params, expected
    reply): step 3's period split in 8 keyed committee requests, 32 single
    recoveries of step 10's signatures, step 10's samples in 8 requests;
    the expected replies are the direct in-process calls', in the wire's
    form."""
    msgs, sig_rows, pk_rows, keys, want = period
    (digests, sigs65, want_addr), (chunks, indices, proofs, roots,
                                   want_ok) = vote
    k = TOPO_THREADS
    cuts = [round(i * SHARDS / k) for i in range(k + 1)]
    jobs = {"committees": [], "recoveries": [], "samples": []}
    for a, b in zip(cuts, cuts[1:]):
        jobs["committees"].append(("shard_verifyCommittees", (
            [codec.enc_bytes(m) for m in msgs[a:b]],
            codec.enc_g1_rows(sig_rows[a:b]),
            codec.enc_g2_rows(pk_rows[a:b]),
            codec.enc_pk_row_keys(keys[a:b])), want[a:b]))
    for i in range(TOPO_RECOVERIES):
        jobs["recoveries"].append(("shard_ecrecover", (
            [codec.enc_bytes(digests[i])], [codec.enc_bytes(sigs65[i])]),
            [None if want_addr[i] is None
             else codec.enc_bytes(bytes(want_addr[i]))]))
    n = len(chunks)
    scuts = [round(i * n / k) for i in range(k + 1)]
    for a, b in zip(scuts, scuts[1:]):
        jobs["samples"].append(("shard_dasVerify", codec.enc_das_call(
            chunks[a:b], indices[a:b], proofs[a:b], roots[a:b]),
            want_ok[a:b]))
    return jobs


def wire_round(address, jobs, rpc_client):
    """One round: TOPO_THREADS threads, each on its own RPCClient, send
    their share of each group at once (a barrier between the groups).
    Returns {group: [(reply, expected, seconds)]}; fails on an error."""
    import threading

    out = {name: [None] * len(group) for name, group in jobs.items()}
    errors = []
    barrier = threading.Barrier(TOPO_THREADS)

    def run(t):
        client = rpc_client(*address, timeout=600)
        try:
            for name, group in jobs.items():
                barrier.wait()
                for i in range(t, len(group), TOPO_THREADS):
                    method, params, expected = group[i]
                    t0 = time.perf_counter()
                    reply = client.call(method, *params)
                    out[name][i] = (reply, expected,
                                    time.perf_counter() - t0)
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(repr(exc))
            barrier.abort()
        finally:
            client.close()

    threads = [threading.Thread(target=run, args=(t,), daemon=True)
               for t in range(TOPO_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if errors or any(t.is_alive() for t in threads):
        fail(f"step 18.1: requests failed or hung: {errors[:3]}")
    return out


def chain_votes(remote, mods, ether):
    """One notary's vote on the chain process's SMC, so that its vote log
    has a period to replay: fund, register with a BLS key, a header and a
    vote in period p, then p sealed. Returns p."""
    am = mods.am
    acct = am.new_account(seed=b"chip-topology-notary")
    remote.fund(acct.address, 2000 * ether)
    remote.register_notary(acct.address, bls_pubkey=acct.bls_pubkey,
                           bls_pop=am.bls_proof_of_possession(acct.address))
    remote.fast_forward(1)
    p = remote.current_period()
    root = mods.Hash32(b"\x18" * 32)
    remote.add_header(acct.address, 0, p, root, b"")
    remote.submit_vote(acct.address, 0, p, 0, root, bls_sig=am.bls_sign(
        acct.address, bytes(mods.vote_digest(0, p, root))))
    remote.fast_forward(1)
    return p


def chain_phase(card: str, period, vote, medians, before_round) -> None:
    """Step 18.1: `python -m gethsharding_tpu_torch.rpc.chain_server
    --sigbackend torch --quorum 1` as a child process; from 8 client
    threads, each on its own `RPCClient`: step 3's period in 8 keyed
    `shard_verifyCommittees` requests (hostile rows included), 32 single
    `shard_ecrecover` calls on step 10's signatures, step 10's samples in
    8 `shard_dasVerify` requests, and one `shard_verifyPeriodBatch` of a
    period with a vote. Fails unless every reply equals the smoke's own
    direct in-process call row for row, the chain process dispatched
    fewer times than it was asked, and its exit line (on stderr) counts
    launches of every kernel of TOPO_KERNELS. Timed: the per-request
    latency over the wire (median, p99) beside step 17's in-process
    serving request and the direct call on one request's rows. The
    chain process boots while the smoke makes the requests and the
    direct calls; `before_round()` runs between the warm-up round and
    the measured one (step 18.2's devnet boots meanwhile)."""
    import tempfile

    from gethsharding_tpu_torch.mainchain.accounts import AccountManager
    from gethsharding_tpu_torch.params import ETHER
    from gethsharding_tpu_torch.rpc import codec
    from gethsharding_tpu_torch.rpc.client import RemoteMainchain, RPCClient
    from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend
    from gethsharding_tpu_torch.smc.state_machine import vote_digest
    from gethsharding_tpu_torch.utils.hexbytes import Hash32

    t0 = time.perf_counter()
    err = tempfile.TemporaryFile(mode="w+")
    cmd = [sys.executable, "-m", "gethsharding_tpu_torch.rpc.chain_server",
           *CHAIN_ARGS]
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), stdout=subprocess.PIPE, stderr=err, text=True)
    jobs = topology_jobs(period, vote, codec)
    # the direct in-process calls: the expected replies are theirs
    direct = TorchSigBackend()
    msgs, sig_rows, pk_rows, keys, want = period
    (digests, sigs65, want_addr), samples = vote[0], vote[1][:4]
    if direct.bls_verify_committees(msgs, sig_rows, pk_rows,
                                    pk_row_keys=keys) != want \
            or direct.ecrecover_addresses(digests, sigs65) != want_addr \
            or direct.das_verify_samples(*samples) != vote[1][4]:
        stop_child(proc)
        fail("step 18.1: the direct calls differ from the known answers")
    try:
        endpoint = json.loads(read_line(proc, 120, "the chain endpoint"))
        address = (endpoint["host"], endpoint["port"])
        start_s = time.perf_counter() - t0
        remote = RemoteMainchain.dial(*address)
        mods = SimpleNamespace(am=AccountManager(), Hash32=Hash32,
                               vote_digest=vote_digest)
        replayed = chain_votes(remote, mods, ETHER)
        # a warm-up round (the chain's line tables built), then the round
        # that is checked for coalescing and timed
        wire_round(address, jobs, RPCClient)
        before_round()
        before = remote.rpc.call("shard_servingStats")["dispatches"]
        calls0 = remote.rpc.call("shard_methodStats")
        got = wire_round(address, jobs, RPCClient)
        t_batch = time.perf_counter()
        batch = remote.verify_period_batch(replayed)
        batch_ms = (time.perf_counter() - t_batch) * 1e3
        after = remote.rpc.call("shard_servingStats")["dispatches"]
        calls = remote.rpc.call("shard_methodStats")
        remote.close()
    finally:
        stop_child(proc)
    err.seek(0)
    log = err.read()
    err.close()
    if proc.returncode != 0:
        fail(f"step 18.1: the chain process exited {proc.returncode}:\n"
             f"{log[-3000:]}")
    for name, rows in got.items():
        bad = [i for i, (reply, want_i, _) in enumerate(rows)
               if reply != want_i]
        if bad:
            fail(f"step 18.1: {name}: replies over the wire differ from "
                 f"the direct call's at requests {bad}")
    if batch is not True:
        fail(f"step 18.1: shard_verifyPeriodBatch({replayed}) gave {batch}")
    ops = {"committees": "bls_verify_committees",
           "recoveries": "ecrecover_addresses",
           "samples": "das_verify_samples"}
    asked = {name: len(jobs[name]) for name in ops}
    dispatched = {name: after[op] - before[op] for name, op in ops.items()}
    method_of = {"committees": "shard_verifyCommittees",
                 "recoveries": "shard_ecrecover",
                 "samples": "shard_dasVerify"}
    served = {name: calls[method_of[name]] - calls0.get(method_of[name], 0)
              for name in ops}
    if served != asked or sum(dispatched.values()) >= sum(asked.values()) \
            or min(dispatched.values()) < 1:
        fail(f"step 18.1: {asked} requests, served {served}, dispatched "
             f"{dispatched}")
    summary = exit_line(log, "chain-server at exit:")
    launched = summary["launches"]
    missing = [k for k in TOPO_KERNELS if not launched.get(k)]
    if missing:
        fail(f"step 18.1: the chain process launched {launched}; none of "
             f"{missing}")
    print(f"chain process (step 18.1): {' '.join(cmd[1:])}: endpoint line "
          f"read {start_s:.1f} s after its start (the direct calls made "
          f"meanwhile); {sum(asked.values())} requests from "
          f"{TOPO_THREADS} client threads, each reply equal to the direct "
          f"in-process call row for row (hostile rows included); "
          f"dispatches {dispatched} for {asked} requests; "
          f"shard_verifyPeriodBatch({replayed}) True in {batch_ms:.1f} ms; "
          f"the chain process's launches at exit {launched} (the warm-up "
          f"round and the measured one, the measured one beside the "
          f"booted devnet of step 18.2) [{card}]", flush=True)
    step17 = {"committees": "committees", "recoveries": "recoveries",
              "samples": "samples"}
    for name in ops:
        lat_ms = [v * 1e3 for _, _, v in got[name]]
        serve17, one17 = medians.get(step17[name], (float("nan"),) * 2)
        print(f"time over the wire, {name} (step 18.1): {len(lat_ms)} "
              f"requests, per-request latency median "
              f"{statistics.median(lat_ms):.2f} ms, p99 "
              f"{pct(lat_ms, 0.99):.2f} ms; in-process serving request "
              f"(step 17.1) median {serve17:.2f} ms; the direct call on "
              f"one request's rows {one17:.2f} ms [{card}]", flush=True)


def find_pids(datadir: str, role: str) -> list:
    """Pids of the devnet's `role` children (their argv names the
    role's datadir under `datadir`), read from /proc."""
    pids = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/cmdline", "rb") as fh:
                argv = fh.read().split(b"\0")
        except OSError:
            continue
        if os.path.join(datadir, role).encode() in argv:
            pids.append(int(entry))
    return pids


def wait_chain(pred, what: str, timeout: float = DEVNET_WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = pred()
        if value:
            return value
        time.sleep(0.2)
    fail(f"step 18.2: {what} did not happen within {timeout:.0f} s")


def voted_period(chain, account, after: int, shards: int = 2):
    """The first sealed period > `after` with a proposed shard, in which
    every proposed shard's record is elected with `account`'s vote (the
    SMC's approved record); None if there is none yet."""
    current = chain.current_period()
    for p in range(after + 1, current):
        records = [chain.collation_record(s, p) for s in range(shards)]
        proposed = [r for r in records if r is not None]
        if proposed and all(
                r.is_elected and any(bytes(v.signer) == bytes(account)
                                     for v in r.vote_sigs.values())
                for r in proposed):
            return p
    return None


class Devnet:
    """Step 18.2's devnet process: started, then booted (its chain's
    endpoint read and dialed, the notary's deposit on it)."""

    def __init__(self):
        import tempfile

        self.datadir = tempfile.mkdtemp(prefix="chip-devnet-")
        self.cmd = [sys.executable, "-m", "gethsharding_tpu_torch.cli",
                    *DEVNET_CMD, "--runtime", str(DEVNET_RUNTIME_S),
                    "--datadir", self.datadir]
        self.t0 = time.perf_counter()
        # its status lines go to a file (a pipe nobody reads would fill),
        # read through a handle of its own
        self.out_path = os.path.join(self.datadir, "devnet.out")
        with open(self.out_path, "w") as out:
            self.proc = subprocess.Popen(
                self.cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                stdout=out, stderr=subprocess.STDOUT, text=True)
        self.marks = {}
        self.chain = self.account = self.up = None

    def mark(self, what: str) -> None:
        self.marks[what] = time.perf_counter() - self.t0

    def boot(self) -> None:
        from gethsharding_tpu_torch.rpc.client import RemoteMainchain

        def up_line():
            with open(self.out_path) as fh:
                for line in fh:
                    if '"event": "up"' in line:
                        return json.loads(line)
            if self.proc.poll() is not None:
                fail(f"step 18.2: the devnet exited {self.proc.returncode} "
                     f"before its up line")
            return None

        self.up = wait_chain(up_line, "the devnet's up line", timeout=120)
        self.chain = RemoteMainchain.dial(self.up["host"], self.up["port"])
        self.mark("up")
        self.account = wait_chain(lambda: self.chain.notary_by_pool_index(0),
                                  "the notary's deposit")
        self.mark("deposit")

    def stop(self) -> str:
        if self.chain is not None:
            self.chain.close()
            self.chain = None
        stop_child(self.proc)
        with open(self.out_path) as fh:
            return fh.read()


def devnet_phase(card: str, net: Devnet) -> None:
    """Step 18.2: `python -m gethsharding_tpu_torch.cli devnet --notaries 1
    --proposers 2 --observers 1 --lights 1 --quorum 1 --shardcount 2
    --sigbackend torch --blocktime 0.2` with a datadir (`Devnet`, started
    with step 18 and booted before step 18.1's measured round): a chain
    process and four actor processes on the card, and a light child,
    which launches nothing. Dialing the chain from here: a
    sealed period in which the notary's vote on each proposed shard is
    the SMC's approved record, both shards approved; then the notary
    SIGKILLed: the devnet respawns it, it comes back with the same
    account (its keystore), no second deposit, and votes again. At exit
    (SIGINT to the devnet, which stops its children with SIGTERM, actors
    first): the notary child's exit line counts launches of
    DEVNET_NOTARY and its heads, the chain child's counts the vote-log
    replay's `keccak_fixed`, the light child's counts no launch (and its
    verified samples and rejected proofs), the observer logged the SMC's
    canonical
    headers of its shard, no child logged a service error or a
    traceback, and the notary missed at most DEVNET_MISSED_PER_VOTE
    votes to the chain sealing their period (`notary/votes_missed`) for
    each vote it cast. Prints the
    framing of the direct p2p frames (AEAD only where `cryptography` is
    installed). The observer replays no collation: no node of a devnet
    writes its canonical body (ROADMAP.md queue A item 8)."""
    chain, account, datadir = net.chain, net.account, net.datadir
    cmd = net.cmd
    try:
        first = wait_chain(lambda: voted_period(chain, account, 0),
                           "a period voted by the notary")
        wait_chain(lambda: all(chain.last_approved_collation(s) > 0
                               for s in (0, 1)), "both shards approved")
        net.mark("voted")
        (victim,) = find_pids(datadir, "notary-0")
        os.kill(victim, signal.SIGKILL)
        killed_at = chain.current_period()
        net.mark("killed")
        respawned = wait_chain(lambda: [p for p in find_pids(
            datadir, "notary-0") if p != victim], "the notary's respawn")
        again = wait_chain(lambda: voted_period(chain, account, killed_at),
                           "a vote of the respawned notary")
        net.mark("voted again")
        # one more period, so that the respawned notary audits its vote
        wait_chain(lambda: chain.current_period() > again + 1,
                   "the period after the vote")
        if chain.notary_by_pool_index(0) != account \
                or chain.notary_by_pool_index(1) is not None \
                or not chain.notary_registry(account).deposited:
            fail(f"step 18.2: the pool after the respawn: "
                 f"{chain.notary_by_pool_index(0)}, "
                 f"{chain.notary_by_pool_index(1)}; want {account} alone")
    finally:
        out = net.stop()
    wall_s = time.perf_counter() - net.t0
    proc = net.proc
    if proc.returncode != 0 or '"event": "shutdown"' not in out:
        fail(f"step 18.2: the devnet exited {proc.returncode}:\n{out[-3000:]}")
    logs = {}
    for name in ("chain", "notary-0", "proposer-0", "proposer-1",
                 "observer-0", "light-0"):
        with open(os.path.join(datadir, "logs", f"{name}.log")) as fh:
            logs[name] = fh.read()
    bad = {name: [line for line in log.splitlines()
                  if "service error" in line or "Traceback" in line]
           for name, log in logs.items()}
    bad = {k: v for k, v in bad.items() if v}
    if bad:
        fail(f"step 18.2: the children logged errors {bad}")
    notary = exit_line(logs["notary-0"], "node at exit:")
    chain_summary = exit_line(logs["chain"], "chain-server at exit:")
    light = exit_line(logs["light-0"], "node at exit:")
    if light["launches"] or "samples_verified" not in light \
            or "actor=light" not in logs["light-0"]:
        fail(f"step 18.2: the light child's exit line {light}")
    missing = [k for k in DEVNET_NOTARY if not notary["launches"].get(k)]
    if missing or not chain_summary["launches"].get("keccak_fixed") \
            or notary["account"].lower() != "0x" + bytes(account).hex():
        fail(f"step 18.2: the notary child's exit line {notary} (none of "
             f"{missing}), the chain child's launches "
             f"{chain_summary['launches']}")
    observed = re.findall(r"(?:Canonical header approved for|Observed "
                          r"canonical collation:) shard 0 period (\d+)",
                          logs["observer-0"])
    # votes the chain sealed the period before: both lives' warnings, and
    # the respawned life's `votes_missed` at exit; votes cast: the first
    # life's, from the journal the respawned one recovered, and its own
    missed = len(re.findall(r"vote on shard \d+ missed the end of period",
                            logs["notary-0"]))
    recovered = re.findall(r"vote journal recovered: (\d+) submitted votes",
                           logs["notary-0"])
    cast = (int(recovered[-1]) if recovered else 0) + notary["votes"]
    if missed > DEVNET_MISSED_PER_VOTE * cast \
            or notary.get("votes_missed", 0) > missed:
        fail(f"step 18.2: the notary missed {missed} votes and cast {cast} "
             f"(at most {DEVNET_MISSED_PER_VOTE} missed a vote cast; "
             f"{notary.get('votes_missed')} in its exit line)")
    from gethsharding_tpu_torch.p2p import direct
    framing = ("AEAD (AES-GCM)" if direct.AESGCM is not None
               else "plaintext (no `cryptography` here)")
    replayed = re.findall(r"Replayed collation: shard 0 period (\d+) "
                          r"applied (\d+)/(\d+) root 0x(\w+) state_root "
                          r"0x(\w+)", logs["observer-0"])
    if not observed:
        fail("step 18.2: the observer logged no canonical header of its "
             "shard")
    starts = logs["notary-0"].count("Starting sharding node")
    print(f"devnet of OS processes (step 18.2): {' '.join(cmd[3:-2])}: "
          f"{len(logs)} children (chain, notary, 2 proposers, observer, "
          f"light); "
          f"period {first} voted by the notary {bytes(account).hex()} on "
          f"each proposed shard (the SMC's approved records), both shards "
          f"approved; the notary SIGKILLed in period {killed_at}, "
          f"respawned as pid {respawned[0]} ({starts} starts in its log) "
          f"with the same account, no second deposit, voted again in "
          f"period {again}; the notary child's launches at exit "
          f"{notary['launches']}; votes cast {cast} and missed {missed} "
          f"in both lives ({notary['votes']} and "
          f"{notary['votes_missed']} in the respawned one); the light "
          f"child's exit line {light}; direct p2p "
          f"frames {framing}; the chain "
          f"child's {chain_summary['launches']} (the vote-log replay); the "
          f"observer saw the SMC's canonical headers of shard 0 for "
          f"periods {sorted(set(map(int, observed)))}, replayed "
          f"{len(replayed)} collations"
          + (f" (roots {[r[3] for r in replayed]})" if replayed else
             " (no node writes an observer's canonical collation: "
             "ROADMAP.md queue A item 8)")
          + f"; no child error; {wall_s:.1f} s, marks "
          + ", ".join(f"{k} {v:.1f}" for k, v in net.marks.items())
          + f" s [{card}]", flush=True)
    heads = notary["heads"]
    print(f"time devnet notary head (step 18.2; the respawned notary child, "
          f"its own log, notary/head_latency): {heads['count']} heads, "
          f"median {heads['p50_ms']:.1f} ms, largest {heads['max_ms']:.1f} "
          f"ms [{card}]", flush=True)


def topology_phase(card: str, period, vote, medians) -> None:
    """Step 18: the cross-process topology on the card: 18.2's devnet
    started first, 18.1's chain process serving the verifications while
    it boots (the measured round once it has), then 18.2; timed."""
    t0 = time.perf_counter()
    net = Devnet()
    try:
        chain_phase(card, period, vote, medians, net.boot)
        t1 = time.perf_counter()
        devnet_phase(card, net)
    finally:
        if net.proc.poll() is None:    # a failed phase: stop the devnet
            net.stop()
    print(f"step 18: {time.perf_counter() - t0:.1f} s in all (the chain "
          f"process {t1 - t0:.1f} s with the devnet booting beside it, "
          f"the devnet {time.perf_counter() - t0:.1f} s from its start)",
          flush=True)


MESH_SLOTS = 4          # slots of cuda:0 where the machine has one card
MESH_REPS = 5           # warm calls timed a layout


def syncs_of(fn) -> dict:
    """Run `fn` under PyTorch's CUDA sync debug mode: the host syncs it
    made, counted by the source line that made them."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return dict(collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message)))


def mesh_slots():
    """Step 19's slots: the distinct cards where there are two or more,
    else MESH_SLOTS slots of cuda:0; and how to say which."""
    n = torch.cuda.device_count()
    if n >= 2:
        return ([torch.device("cuda", i) for i in range(n)],
                f"{n} distinct cards")
    return ([torch.device("cuda", 0)] * MESH_SLOTS,
            f"{MESH_SLOTS} slots of cuda:0 (one card: the layout, padding, "
            f"per-slot caches, launches and reduction run on real kernels; "
            f"copies between distinct cards do not)")


def slot_launch_line(launches) -> str:
    return "; ".join(f"slot {i}: " + ", ".join(
        f"{k} {v}" for k, v in sorted(d.items())) for i, d in
        enumerate(launches))


def mesh_phase(card: str, period, built) -> None:
    """Step 19: the shard mesh (`parallel/mesh.py`) over `mesh_slots()`:
    (1) the committee audit of step 3's period through
    `TorchSigBackend(device=slots)`, keyed cold and warm and unkeyed;
    (2) `CommitteePeriodPipeline` on that period plus one shard, over the
    1-D mesh and a 2 × 2 ("dcn", "ici") mesh; (3) config 5's mesh form
    on step 13's inputs (`built`), at 1,024 and 1,023 shards; (4) the dry
    run twin on the slots, and `sharding --mesh-devices N` with N above
    the visible cards, which must exit non-zero with the reference's
    message. Each against the single-device path, bit for bit; one
    reduction per mesh axis a step; timed warm beside one device."""
    t_step = time.perf_counter()
    slots, what = mesh_slots()
    too_many = torch.cuda.device_count() + 1
    cli = start_cli(["sharding", "--actor", "notary", "--runtime", "1",
                     "--mesh-devices", str(too_many)])
    try:
        mesh_checks(card, period, built, slots, what)
    except BaseException:
        stop_cli(cli)
        raise
    log, cli_s = finish_cli(cli, "step 19.4")
    msg = f"requested {too_many} devices, only {too_many - 1} visible"
    if cli[1].returncode == 0 or msg not in log:
        fail(f"step 19.4: `sharding --mesh-devices {too_many}` exited "
             f"{cli[1].returncode}: {log[-2000:]}")
    print(f"mesh CLI: `sharding --mesh-devices {too_many}` exited "
          f"{cli[1].returncode} with {msg!r} ({cli_s:.1f} s)", flush=True)
    print(f"step 19: {time.perf_counter() - t_step:.1f} s in all",
          flush=True)


def mesh_checks(card: str, period, built, slots, what: str) -> None:
    """Steps 19.1-19.4 but the CLI's (`mesh_phase`)."""
    from gethsharding_tpu_torch.crypto import bn256 as bls
    from gethsharding_tpu_torch.parallel import mesh, period as pp, stress
    from gethsharding_tpu_torch.parallel.dryrun import dryrun_multichip
    from gethsharding_tpu_torch.params import Config
    from gethsharding_tpu_torch.sigbackend.dispatch import TorchSigBackend

    n_slots = len(slots)
    print(f"mesh (step 19): {what}", flush=True)
    msgs, sig_rows, pk_rows, keys, want = period

    # 19.1 the committee audit
    single = TorchSigBackend(device=slots[0])
    meshed = TorchSigBackend(device=slots)
    for label, row_keys in (("keyed, cold", keys), ("keyed, warm", keys),
                            ("unkeyed (recompute)", None)):
        reductions = meshed.layout.mesh.reductions
        got, launched = launches_of(lambda: meshed.bls_verify_committees(
            msgs, sig_rows, pk_rows, pk_row_keys=row_keys))
        info = meshed.last_mesh
        if got != want or got != single.bls_verify_committees(
                msgs, sig_rows, pk_rows, pk_row_keys=row_keys):
            fail(f"step 19.1: the mesh audit ({label}) differs from the "
                 f"known verdicts or the single-device backend")
        if (info["collectives"], meshed.layout.mesh.reductions
                - reductions) \
                != (1, 1) or info["verdict_devices"] != n_slots \
                or info["vote_total"] != sum(want) \
                or info["precomp"] != (row_keys is not None):
            fail(f"step 19.1: the mesh record ({label}) {info}")
        need = {"agg_g1", "finalexp"} | (
            {"miller", "agg_g2"} if row_keys is None else {"tower"})
        if label == "keyed, cold":
            need.add("agg_g2")
        for i, d in enumerate(info["slot_launches"]):
            if not need <= set(d) or d.get("agg_g1") != 1 \
                    or d.get("finalexp") != 1:
                fail(f"step 19.1: slot {i} ({label}) launched {d}")
        print(f"mesh audit ({label}, {SHARDS} x {COMMITTEE} over "
              f"{n_slots} slots, bucket {info['bucket']}): {sum(got)} of "
              f"{SHARDS} verified, equal to one device; "
              f"{info['collectives']} reduction; launches "
              f"{slot_launch_line(info['slot_launches'])} [{card}]",
              flush=True)
    ptrs = [{t.untyped_storage().data_ptr() for t in c.tensors()}
            for c in meshed.line_shards]
    if any(not p for p in ptrs) or any(
            ptrs[i] & ptrs[j] for i in range(n_slots)
            for j in range(i + 1, n_slots)):
        fail("step 19.1: the slots' line-table caches share a tensor or "
             "one is empty")
    times = {}
    for label, row_keys in (("keyed warm", keys), ("unkeyed", None)):
        for name, b in (("mesh", meshed), ("single", single)):
            times[label, name] = host_ms(
                lambda: b.bls_verify_committees(msgs, sig_rows, pk_rows,
                                                pk_row_keys=row_keys),
                MESH_REPS)
    syncs = {label: syncs_of(lambda: meshed.bls_verify_committees_async(
        msgs, sig_rows, pk_rows, pk_row_keys=row_keys))
        for label, row_keys in (("keyed warm", keys), ("unkeyed", None))}
    print(f"mesh audit host syncs from staging to the last slot's launch "
          f"and the reduction (before the verdicts' pull), by line: {syncs}",
          flush=True)
    print(f"time mesh audit (warm, median of {MESH_REPS}, to the verdicts): "
          + ", ".join(f"{label} {times[label, 'mesh']:.1f} ms over "
                      f"{n_slots} slots against {times[label, 'single']:.1f}"
                      f" ms on one device" for label in ("keyed warm",
                                                         "unkeyed"))
          + f"; the slots' caches hold {[len(c) for c in meshed.line_shards]}"
            f" tables, disjoint [{card}]", flush=True)

    # 19.2 the committee period pipeline, one extra shard: uneven
    extra = b"period-mesh/extra-shard"
    h = bls.hash_to_g1(extra)
    votes = [bls.g1_mul(j + 1, h) for j in range(COMMITTEE)]
    pks = [bls.g2_mul(j + 1, bls.G2_GEN) for j in range(COMMITTEE)]
    headers = list(msgs) + [extra]
    srows, prows = list(sig_rows) + [votes], list(pk_rows) + [pks]
    cfg = Config()
    one = pp.CommitteePeriodPipeline(cfg, device=slots[0])
    inputs = one.build_inputs(headers, srows, prows)
    base = one.run(inputs)
    if base.verified.tolist() != want + [True]:
        fail("step 19.2: the single-device period pipeline's verdicts")
    layouts = [("1-D", mesh.make_mesh(devices=slots), 1)]
    if n_slots % 2 == 0:
        layouts.append(("2-D", mesh.make_multihost_mesh(
            n_slots // 2, 2, slots), 2))
    for label, m, axes in layouts:
        out = pp.CommitteePeriodPipeline(cfg, mesh=m).run(inputs)
        if m.reductions != axes or any(
                not torch.equal(getattr(out, f).cpu(), getattr(base, f).cpu())
                for f in pp.PeriodOutputs._fields):
            fail(f"step 19.2: the period pipeline on the {label} mesh "
                 f"differs from one device")
    equal_on = ", ".join(f"{label} ({axes} reductions)"
                         for label, _, axes in layouts)
    print(f"mesh period pipeline: {SHARDS + 1} shards, verified "
          f"{int(base.verified.sum())}, approved {int(base.approved.sum())} "
          f"(quorum {cfg.quorum_size}), totals votes {int(base.total_votes)}"
          f", approved {int(base.total_approved)}; equal on {equal_on} and "
          f"one device [{card}]", flush=True)

    # 19.3 config 5's mesh form on step 13's inputs
    inputs, pool, bh, size = built
    cfg2 = Config(quorum_size=2)
    m1 = mesh.make_mesh(devices=slots)
    for shards in (STRESS_SHARDS, STRESS_SHARDS - 1):
        cut = stress.StressInputs(*(a[:shards] for a in inputs))
        base = stress.StressPipeline(cfg2).run(cut, pool, bh, 1, size)
        reductions = m1.reductions
        out, launched = launches_of(lambda: stress.StressPipeline(
            cfg2, mesh=m1).run(cut, pool, bh, 1, size))
        if m1.reductions - reductions != 1:
            fail("step 19.3: the stress mesh reduced more than once")
        diff = [f for f in stress.StressOutputs._fields
                if not torch.equal(getattr(out, f).cpu(),
                                   getattr(base, f).cpu())]
        if diff:
            fail(f"step 19.3: the stress mesh at {shards} shards differs "
                 f"from one device in {diff}")
        if int(out.total_votes) != shards * STRESS_VOTES \
                or int(out.total_txs) != shards * STRESS_TXS:
            fail(f"step 19.3: the stress mesh's totals at {shards} shards")
        syncs = syncs_of(lambda: stress.StressPipeline(cfg2, mesh=m1).run(
            cut, pool, bh, 1, size))
        mesh_ms = host_ms(lambda: stress.StressPipeline(cfg2, mesh=m1).run(
            cut, pool, bh, 1, size).total_txs.item(), MESH_REPS)
        one_ms = host_ms(lambda: stress.StressPipeline(cfg2).run(
            cut, pool, bh, 1, size).total_txs.item(), MESH_REPS)
        print(f"mesh stress step: {shards} shards over {n_slots} slots "
              f"({-(-shards // n_slots)} a slot), every plane and total "
              f"equal to one device, 1 reduction; launches "
              f"{ {k: v for k, v in launched.items() if k != 'norm'} } "
              f"({launched.get('norm', 0)} norm); host syncs before the "
              f"totals' pull, by line: {syncs}; time (warm, median of "
              f"{MESH_REPS}, to the totals' pull) {mesh_ms:.2f} ms against "
              f"{one_ms:.2f} ms on one device [{card}]", flush=True)

    # 19.4 the dry run twin, and the CLI asking for too many cards
    t0 = time.perf_counter()
    summary = dryrun_multichip(slots)
    print(f"mesh dry run: {summary} in {time.perf_counter() - t0:.1f} s",
          flush=True)


def exact_phase(seed: int) -> int:
    """Step 8, in a process of its own with GETHSHARDING_TORCH_LIMB_FORM=
    exact. Prints its lines and, last, one `EXACT_KERNEL <json>` line per
    kernel of the exact form (norm_exact, tower_exact, conv_exact): their
    entries of the kernels line."""
    if not torch.cuda.is_available():
        fail("no CUDA device")
    from gethsharding_tpu_torch.crypto import bn256 as bls
    from gethsharding_tpu_torch.ops import (_build, conv, limb, norm, route,
                                            tower)
    from gethsharding_tpu_torch.ops import bn256 as bn
    from gethsharding_tpu_torch.ops import megakernels as mk
    from gethsharding_tpu_torch.sigbackend.dispatch import (TorchSigBackend,
                                                         committee_planes)

    if limb.LIMB_FORM != "exact" or limb.NLIMBS != 22:
        fail("the exact phase did not run in the exact limb form")
    if (tower.KERNEL.name, conv.KERNEL.name, norm.KERNEL.name) != \
            ("tower_exact", "conv_exact", "norm_exact"):
        fail("the exact form's kernels are not counted under their names")
    card = card_line()
    laps = [("start", time.perf_counter())]
    lap = lambda name: laps.append((name, time.perf_counter()))
    dev = torch.device("cuda")
    _build.build()
    msgs, sig_rows, pk_rows, keys, want = make_period(bls, seed)
    lap("build and period")
    if not TorchSigBackend().precomp:
        fail("the exact form's backend is not on the precomp path")

    combs = {"_COMB_FP2": bn._COMB_FP2, "_COMB_FP2_SQR": bn._COMB_FP2_SQR,
             "_COMB": bn._COMB, "_LCOMB": bn._LCOMB,
             "identity": limb._IDENTITY}
    plans = {"fp_mul": bn.FP.mul_plan, "fp2_mul": bn._FP2_MUL,
             "fp2_sqr": bn._FP2_SQR, "fp12_mul": bn._FP12_MUL,
             "fp12_mul_line": bn._LINE_MUL}
    plan_names = {id(p): name for name, p in plans.items()}
    edge = check_tower_edges(bn, tower, conv, norm, route, plans, combs, dev,
                             (22, 25, 43, 45, 49, 52))
    cover = {"tower_exact": TOWER_COVER, "conv_exact": CONV_COVER,
             "norm_exact": "widths 22, 25, 43, 45, 49, 52, 1000 rows, "
                           "negative and ±2^30.7 limbs, -1 limbs, a "
                           "partial block, leading dims"}
    for name, err in (("tower_exact", edge["tower"]),
                      ("conv_exact", edge["conv"]),
                      ("norm_exact", edge["norm"])):
        print(f"exact form: kernel {name}: max |kernel - plain| over limbs "
              f"= {err} (tolerance 0; {cover[name]}; 22-limb operands)",
              flush=True)
        if err:
            fail(f"{name} disagrees with its plain version")
    # the ladder's carries as its tail runs them, the tail, and the whole
    # normalize, on rows that run the carries' longest chains
    crafted = norm.carry_edge_rows(seed, random_rows=4000).to(dev)
    carry_err = max(max_abs_err(norm.carry_probe(crafted, nout),
                                norm.carry_plain(crafted, nout))
                    for nout in norm.CARRY_WIDTHS)
    tail_err = max_abs_err(norm.tail_probe(bn.FP, crafted),
                           norm.tail_plain(bn.FP, crafted))
    crafted_err = max_abs_err(bn.FP.normalize(crafted),
                              norm.normalize_plain(bn.FP, crafted))
    print(f"exact form: the ladder's carries as its tail runs them "
          f"(gs_norm_carry) into "
          f"{norm.CARRY_WIDTHS} limbs: max |kernel - limb.carry| = "
          f"{carry_err}; its tail alone (gs_norm_tail): max |kernel - "
          f"tail_plain| = {tail_err}; norm_exact on the same rows: max "
          f"|kernel - plain| = {crafted_err} (tolerance 0; "
          f"{crafted.shape[0]} rows: "
          f"whole-width carries and borrows, alternating 0/4095, negative "
          f"values, carries off the top, ±2^28 and int32-edge limbs, "
          f"seeded rows within ±2^26)", flush=True)
    if carry_err or tail_err or crafted_err:
        fail("the exact carry, tail or norm_exact disagrees with its plain "
             "version on the crafted rows")
    edge["norm"] = max(edge["norm"], crafted_err)

    lap("edges")
    # -- the recompute audit (keys, precomp off) ----------------------------
    backend = TorchSigBackend(precomp=False)
    bls.hash_to_g1.cache_clear()
    for k in _build.KERNELS.values():
        k.launches = 0
    with TowerLaunches(tower, norm, {}) as log:
        got = backend.bls_verify_committees(msgs, sig_rows, pk_rows,
                                            pk_row_keys=keys)
    launches = _build.launch_counts()
    timing = backend.last_timing
    print(f"exact form: recompute audit with keys, precomp off: launches "
          f"{launches}, limb form {timing['limb_form']}, precomp "
          f"{timing['precomp']}", flush=True)
    if got != want:
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        fail(f"exact-form verdicts differ from the expected list at {bad}")
    if any(launches[name] != 1 for name in mk.KERNELS) \
            or launches["norm_exact"] < 1 or launches["tower_exact"] \
            or launches["conv_exact"] or timing["precomp"] \
            or timing["limb_form"] != "exact":
        fail(f"the exact-form audit did not run each audit kernel once and "
             f"its normalizes in the exact kernel: {launches}")
    rec_norm_launches = launches["norm_exact"]
    rec_norm = check_samples(log.samples, tower, norm, route)["norm"]
    print(f"exact form: kernel norm_exact: max |kernel - plain| over limbs "
          f"= {rec_norm} (tolerance 0) on the recompute audit's inputs "
          f"({len(log.samples)} shapes: "
          f"{sorted(key[1] for key in log.samples)})", flush=True)
    if rec_norm:
        fail("the exact normalize disagrees with its plain version on the "
             "audit")

    planes = committee_planes(msgs, sig_rows, pk_rows)
    on_card = [torch.as_tensor(a, device=dev) for a in planes]
    if on_card[0].shape[-1] != 22:
        fail(f"the host shipped {on_card[0].shape[-1]}-limb planes")
    hx, hy, sx, sy, sm, gx, gy, gm, hok = on_card
    f_k, verdict_k = audit_steps(bn, mk, *on_card)
    with route.plain_versions():
        f_p, verdict_p = audit_steps(bn, mk, *on_card)
    err_f = max_abs_err(f_k, f_p)
    print(f"exact form: Miller product f {tuple(f_k.shape)} against the "
          f"plain versions on the card: max |kernel - plain| = {err_f}; "
          f"verdicts equal: {torch.equal(verdict_k, verdict_p)}", flush=True)
    if err_f or not torch.equal(verdict_k, verdict_p) \
            or verdict_p.cpu()[:SHARDS].tolist() != got:
        fail("the exact-form f or verdicts differ from the plain route")
    print(f"exact form: {sum(got)} of {SHARDS} rows verified, hostile rows "
          f"{', '.join(map(str, HOSTILE))} rejected; plain versions agree")

    lap("recompute audit")
    # -- the precomp audit (keys): cold, then warm ----------------------------
    pbackend = TorchSigBackend()
    for k in _build.KERNELS.values():
        k.launches = 0
    got = pbackend.bls_verify_committees(msgs, sig_rows, pk_rows,
                                         pk_row_keys=keys)
    cold_launches = _build.launch_counts()
    cold_timing = pbackend.last_timing
    print(f"exact form: precomp path, cold: launches {cold_launches}, G2 "
          f"bytes {cold_timing['g2_wire_bytes']}, hit rows "
          f"{cold_timing['hit_rows']}", flush=True)
    if got != want:
        fail("exact-form cold precomp verdicts differ from the expected "
             "list")
    if not cold_timing["precomp"] or cold_launches["tower_exact"] < 1 \
            or cold_launches["norm_exact"] < 1 or cold_launches["miller"] \
            or cold_launches["conv_exact"] \
            or any(cold_launches[n] != 1 for n in ("agg_g1", "agg_g2",
                                                    "finalexp")):
        fail(f"the exact-form cold precomp audit did not run its tower "
             f"products in tower_exact and each sum and the final "
             f"exponentiation once: {cold_launches}")
    pointful = sum(1 for r in pk_rows if r)
    table_bytes = pbackend.lines.bytes // max(1, len(pbackend.lines))
    for k in _build.KERNELS.values():
        k.launches = 0
    with TowerLaunches(tower, norm, plan_names) as warm_log:
        got = pbackend.bls_verify_committees(msgs, sig_rows, pk_rows,
                                             pk_row_keys=keys)
    warm_launches = _build.launch_counts()
    warm_timing = pbackend.last_timing
    print(f"exact form: precomp path, warm: launches {warm_launches}, G2 "
          f"bytes {warm_timing['g2_wire_bytes']}, hit rows "
          f"{warm_timing['hit_rows']} of {pointful} non-empty; "
          f"{len(pbackend.lines)} resident tables of {table_bytes} B",
          flush=True)
    if got != want:
        fail("exact-form warm precomp verdicts differ from the expected list")
    if not warm_timing["memo"] or warm_timing["g2_wire_bytes"] != 0 \
            or warm_timing["hit_rows"] != pointful:
        fail("the exact-form warm precomp audit missed the memo, shipped G2 "
             "bytes or missed a row")
    if warm_launches["tower_exact"] < 1 or warm_launches["agg_g2"] \
            or warm_launches["miller"] or warm_launches["conv_exact"] \
            or warm_launches["finalexp"] != 1 or warm_launches["agg_g1"] != 1:
        fail(f"the exact-form warm precomp audit did not run on tower_exact "
             f"alone beside one G1 sum and one final exponentiation: "
             f"{warm_launches}")
    if table_bytes != 88 * 3 * 2 * 22 * 4 + 1:
        fail(f"the exact form's resident tables take {table_bytes} B")
    sample_err = check_samples(warm_log.samples, tower, norm, route)
    for name, key in (("tower_exact", "tower"), ("norm_exact", "norm")):
        shapes = sum(1 for k in warm_log.samples if k[0] == key)
        print(f"exact form: kernel {name}: max |kernel - plain| over limbs "
              f"= {sample_err[key]} (tolerance 0) on the warm audit's "
              f"inputs ({shapes} shapes)", flush=True)
        if sample_err[key]:
            fail(f"{name} disagrees with its plain version on the audit")

    table, inf = bn.precompute_g2_lines(gx, gy, gm)
    fk, ok = bn.bls_committee_precomp_miller(hx, hy, sx, sy, sm, table, inf,
                                             hok)
    with route.plain_versions():
        table_p, inf_p = bn.precompute_g2_lines(gx, gy, gm)
        fp, ok_p = bn.bls_committee_precomp_miller(hx, hy, sx, sy, sm,
                                                   table_p, inf_p, hok)
        verdict_plain = bn.bls_committee_precomp_finalexp(fp, ok_p)
    err_table, err_f = max_abs_err(table, table_p), max_abs_err(fk, fp)
    print(f"exact form: precomp line tables {tuple(table.shape)} and f "
          f"{tuple(fk.shape)} against the plain route on the card: max "
          f"|kernel - plain| = {err_table} and {err_f}", flush=True)
    if table.shape[1:] != (88, 3, 2, 22) or err_table or err_f \
            or not torch.equal(inf, inf_p) or not torch.equal(ok, ok_p):
        fail("the exact-form precomp tables or f differ from the plain "
             "route")
    if verdict_plain.cpu()[:SHARDS].tolist() != want:
        fail("the exact-form plain route's precomp verdicts differ from the "
             "expected list")
    print(f"exact form: precomp path: {sum(got)} of {SHARDS} rows verified "
          f"cold and warm, hostile rows rejected; plain route agrees")

    lap("precomp audit")
    votes = aggregate_votes(bls, msgs, sig_rows, pk_rows, want)
    aggregates_phase("exact form: ", bls, bn, route, _build, pbackend, votes,
                     card)
    lap("aggregate votes")
    # the multiproof phase's hostile and infinity rows at 22 limbs
    from gethsharding_tpu_torch.das import pcs
    _, hostile, hostile_want = poly_hostile(pcs, bls, seed)
    multiproof_check("exact form: ", pcs, bn, route, _build, pbackend,
                     hostile, hostile_want)
    lap("multiproofs")
    # -- times ---------------------------------------------------------------
    votes_n = SHARDS * COMMITTEE
    results = {}
    for label, be, fresh in (("recompute (keys, precomp off)", backend, None),
                             ("precomp (keys)", pbackend, TorchSigBackend)):
        run = lambda: be.bls_verify_committees(msgs, sig_rows, pk_rows,
                                               pk_row_keys=keys)
        warm_s, marshal_s = [], []
        for _ in range(7):
            t0 = time.perf_counter()
            run()
            warm_s.append(time.perf_counter() - t0)
            marshal_s.append(be.last_timing["marshal_s"])
        cold_s, steady_s = [], []
        for _ in range(3):      # new messages; precomp: a new backend too
            bls.hash_to_g1.cache_clear()
            new = fresh() if fresh else be
            t0 = time.perf_counter()
            new.bls_verify_committees(msgs, sig_rows, pk_rows,
                                      pk_row_keys=keys)
            cold_s.append(time.perf_counter() - t0)
        if fresh:               # new messages, tables resident
            for _ in range(3):
                bls.hash_to_g1.cache_clear()
                t0 = time.perf_counter()
                run()
                steady_s.append(time.perf_counter() - t0)
        dev_ms, _ = device_times(run)
        split = kernel_split(dev_ms)
        busy = sum(split.values())
        cold_ms = statistics.median(cold_s) * 1e3
        warm_ms = statistics.median(warm_s) * 1e3
        steady = (f"; a period of new messages with resident tables median "
                  f"{statistics.median(steady_s) * 1e3:.1f} ms of 3, "
                  f"{votes_n / statistics.median(steady_s):.0f} votes/s") \
            if steady_s else ""
        print(f"time audit, exact form, {label}: cold period (messages "
              f"hashed{', tables built' if fresh else ''}) median "
              f"{cold_ms:.1f} ms of 3, {votes_n / cold_ms * 1e3:.0f} votes/s; "
              f"warm median {warm_ms:.1f} ms of 7, "
              f"{votes_n / warm_ms * 1e3:.0f} votes/s, host marshal "
              f"{statistics.median(marshal_s) * 1e3:.1f} ms{steady}; device "
              f"kernels {busy:.2f} ms under the profiler "
              f"({', '.join(f'{k} {v:.2f}' for k, v in split.items())}), "
              f"idle share {1 - busy / warm_ms:.3f} [{card}]", flush=True)
        results[label] = split

    entries = []
    # the exact normalize at its most frequent shape of the recompute audit
    key = max(log.counts, key=log.counts.get)
    sample = log.samples[key]
    ms = cuda_ms(lambda: norm.normalize_kernel(*sample), 50)
    plain_ms = cuda_ms(lambda: norm.normalize_plain(*sample), 5,
                       queued=False)
    r = norm_exact_work(key)
    audit_bound = sum(norm_exact_work(k)["bound_ms"] * c
                      for k, c in log.counts.items())
    print(f"time norm_exact: kernel {ms:.4f} ms per launch at {key[1]} "
          f"({log.counts[key]} of {rec_norm_launches} launches per "
          f"recompute audit; {warm_launches['norm_exact']} per warm precomp "
          f"audit), plain {plain_ms:.3f} ms, bound {r['bound_ms']:.6f} ms "
          f"({r['bound_by']}: {r['multiply_adds']} multiply-adds, "
          f"{r['bytes']} B); per recompute audit: "
          f"{results['recompute (keys, precomp off)']['norm_kernel']:.3f} ms "
          f"summed kernel time (profiler), bound {audit_bound:.5f} ms "
          f"[{card}]", flush=True)
    entries.append({
        "name": "norm_exact", "route": "cuda", "source": norm.KERNEL.source,
        "replaces": norm.KERNEL.replaces,
        "launches": warm_launches["norm_exact"],
        "max_abs_err": max(edge["norm"], rec_norm, sample_err["norm"]),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None})

    # the exact normalize at each shape of the warm precomp audit
    for key in sorted(k for k in warm_log.counts if k[0] == "norm"):
        sample = warm_log.samples[key]
        ms_w = cuda_ms(lambda: norm.normalize_kernel(*sample), 50)
        r_w = norm_exact_work(key)
        print(f"time norm_exact: kernel {ms_w:.5f} ms per launch at {key[1]} "
              f"({warm_log.counts[key]} launches per warm precomp audit), "
              f"bound {r_w['bound_ms']:.6f} ms ({r_w['bound_by']}) [{card}]",
              flush=True)

    # the exact tower at each shape of the warm precomp audit
    warm_counts = warm_log.counts
    tower_keys = sorted((k for k in warm_counts if k[0] == "tower"),
                        key=lambda k: -warm_counts[k])
    tower_bound = sum(tower_work(k, warm_log.samples[k][0])["bound_ms"]
                      * warm_counts[k] for k in tower_keys)
    for key in tower_keys:
        sample = warm_log.samples[key]
        ms = cuda_ms(lambda: tower.tower_kernel(*sample), 50)
        with route.plain_versions():
            plain_ms = cuda_ms(lambda: sample[0].plain(*sample[1:]), 5,
                               queued=False)
        r = tower_work(key, sample[0])
        print(f"time tower_exact: kernel {ms:.4f} ms per launch at {key[1]} "
              f"{key[2]} x {key[3]} ({warm_counts[key]} launches per warm "
              f"audit), plain route {plain_ms:.3f} ms, bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']}: "
              f"{r['multiply_adds']} multiply-adds at 484 per conv, "
              f"{r['bytes']} B) [{card}]", flush=True)
        if key == tower_keys[0]:
            entries.append({
                "name": "tower_exact", "route": "cuda",
                "source": tower.KERNEL.source,
                "replaces": tower.KERNEL.replaces,
                "launches": warm_launches["tower_exact"],
                "max_abs_err": max(edge["tower"], sample_err["tower"]),
                "ms": ms, "plain_ms": plain_ms, "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None})
    print(f"time tower_exact: per warm precomp audit "
          f"{warm_launches['tower_exact']} launches, "
          f"{results['precomp (keys)']['tower_kernel']:.2f} ms summed kernel "
          f"time (profiler), bound {tower_bound:.4f} ms; cold audit "
          f"{cold_launches['tower_exact']} launches [{card}]", flush=True)

    # the 22-limb conv at the line product (x read in place along the six
    # outputs): its device code runs in every tower launch
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    n = hx.shape[0]
    lx = torch.randint(0, 1 << 12, (n, 1, 3, 2, 22), generator=gen,
                       device=dev, dtype=torch.int32)
    ly = torch.randint(0, 1 << 12, (n, 6, 3, 2, 22), generator=gen,
                       device=dev, dtype=torch.int32)
    err = max_abs_err(conv.conv_kernel(lx, ly, bn._LCOMB),
                      conv.pair_conv_combine_plain(lx, ly, bn._LCOMB))
    if err:
        fail("conv_exact disagrees with its plain version at the line "
             "product")
    ms = cuda_ms(lambda: conv.conv_kernel(lx, ly, bn._LCOMB), 50)
    plain_ms = cuda_ms(lambda: conv.pair_conv_combine_plain(lx, ly,
                                                            bn._LCOMB), 5,
                       queued=False)
    key = ("conv", "_LCOMB", tuple(lx.shape), tuple(ly.shape))
    r = conv_work(key, bn._LCOMB)
    print(f"time conv_exact: kernel {ms:.4f} ms per launch at {key[1:]}, "
          f"plain {plain_ms:.3f} ms, bound {r['bound_ms']:.6f} ms "
          f"({r['bound_by']}: {r['multiply_adds']} multiply-adds at 484 per "
          f"term, {r['bytes']} B); per warm precomp audit "
          f"{warm_launches['conv_exact']} launches (its device code runs in "
          f"every tower_exact launch) [{card}]", flush=True)
    entries.append({
        "name": "conv_exact", "route": "cuda", "source": conv.KERNEL.source,
        "replaces": conv.KERNEL.replaces,
        "launches": warm_launches["conv_exact"],
        "max_abs_err": max(edge["conv"], err), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": None})
    lap("times")
    print("exact form: seconds by section: " + ", ".join(
        f"{name} {t - prev:.1f}" for (_, prev), (name, t)
        in zip(laps, laps[1:])), flush=True)
    for entry in entries:
        print("EXACT_KERNEL " + json.dumps(entry))
    return 0


def run_exact_phase(seed: int) -> list:
    """Step 8 in a subprocess with the exact limb form: forwards its lines
    and returns its kernel entries; its failure fails the run."""
    env = dict(os.environ, GETHSHARDING_TORCH_LIMB_FORM="exact")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--exact-phase",
         "--seed", str(seed)], env=env, capture_output=True, text=True,
        timeout=900)
    entries = []
    for line in proc.stdout.splitlines():
        if line.startswith("EXACT_KERNEL "):
            entries.append(json.loads(line[len("EXACT_KERNEL "):]))
        else:
            print(line)
    if proc.returncode != 0 or len(entries) != 3:
        print(proc.stderr[-4000:], file=sys.stderr)
        fail(f"the exact-form phase failed (exit {proc.returncode})")
    return entries


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--exact-phase", action="store_true",
                        help="run step 8 alone (as the script runs it, "
                             "with GETHSHARDING_TORCH_LIMB_FORM=exact)")
    parser.add_argument("--stress-inputs", default="", metavar="PATH",
                        help="build step 13's inputs on the host and save "
                             "them to PATH (as the script runs it)")
    parser.add_argument("--roots-phase", action="store_true",
                        help="check and time the trie roots on the host "
                             "(as the script runs it, beside step 13's "
                             "host build)")
    args = parser.parse_args()
    if args.exact_phase:
        return exact_phase(args.seed)
    if args.stress_inputs:
        return stress_inputs(args.stress_inputs, args.seed)
    if args.roots_phase:
        return roots_phase(args.seed)
    if not torch.cuda.is_available():
        fail("no CUDA device")
    t_smoke = time.perf_counter()

    from gethsharding_tpu_torch.crypto import bn256 as bls
    from gethsharding_tpu_torch.crypto import keccak
    from gethsharding_tpu_torch.ops import (_build, conv, limb, norm, route,
                                            tower)
    from gethsharding_tpu_torch.ops import bn256 as bn
    from gethsharding_tpu_torch.ops import megakernels as mk
    from gethsharding_tpu_torch.sigbackend.dispatch import (TorchSigBackend,
                                                         committee_planes)

    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc, sm_90a)")
    stress_build = start_stress_build(args.seed)
    roots = start_roots_phase(args.seed)
    print("step 13's host build and the trie roots' phase run in processes "
          "of their own from here to step 13: the host times of steps 1-12 "
          "(marshal, latency and build lines) are taken beside them, on "
          "two more busy cores", flush=True)
    if limb.LIMB_FORM != "wide":
        fail("the main phases run in the wide limb form")
    if not keccak.native_available():
        fail("the host hash did not load its compiled keccak (csrc/keccak.c)")
    print("hash: keccak256 runs the compiled csrc/keccak.c (ctypes)")
    for name, regs, stack, stores, loads in ptxas_report(_build.build_log):
        print(f"  ptxas {name}: {regs} registers, stack frame {stack} B, "
              f"spill stores {stores} B, spill loads {loads} B")
    # the exact form's instances: its ladder keeps every limb in registers
    for name, regs, stack, stores, loads in exact_ptxas(_build.build_log):
        print(f"exact form: ptxas {name}: {regs} registers, stack frame "
              f"{stack} B, spill stores {stores} B, spill loads {loads} B")
        if stack or stores or loads:
            fail(f"the exact instance {name} has a stack frame or spills")

    t0 = time.perf_counter()
    msgs, sig_rows, pk_rows, keys, want = make_period(bls, args.seed)
    print(f"period: {SHARDS} shards × {COMMITTEE} votes, made in "
          f"{time.perf_counter() - t0:.1f} s on the host", flush=True)

    # -- every kernel against its plain version, at the audit's tensors --
    dev = torch.device("cuda")
    planes = committee_planes(msgs, sig_rows, pk_rows)
    on_card = [torch.as_tensor(a, device=dev) for a in planes]
    hx, hy, sx, sy, sm, gx, gy, gm, hok = on_card
    n = hx.shape[0]
    sm32, gm32 = sm.to(torch.int32), gm.to(torch.int32)

    agg1 = lambda: mk.agg_kernel(sx, sy, sm32, fp2=False)
    agg1_p = lambda: mk.run_agg_plain(sx, sy, sm, fp2=False)
    agg2 = lambda: mk.agg_kernel(gx, gy, gm32, fp2=True)
    agg2_p = lambda: mk.run_agg_plain(gx, gy, gm, fp2=True)
    sig = tuple(bn.FP.normalize(v) for v in agg1())
    pk = tuple(bn.FP.normalize(v) for v in agg2())
    h = (hx, hy)
    mil = lambda: mk.miller_kernel(sig, h, pk)
    mil_p = lambda: mk.run_miller_plain(sig, h, pk)
    f = bn.FP.normalize(mil())
    nd = torch.stack([bn.fp12_conj(f), bn.FP.normalize(f)], dim=1)
    fe = lambda: mk.finalexp_kernel(nd)
    fe_p = lambda: mk.run_program_plain(nd)

    # The bound counts the work this period needs, not the padded launch:
    # a row of m votes needs m - 1 additions (the kernels walk a 256-slot
    # tree), and only the real rows with both sums non-empty need a
    # pairing (the launches also cover the 12 pad rows and the empty one).
    adds_g1 = int((sm.sum(dim=1) - 1).clamp(min=0).sum().item())
    adds_g2 = int((gm.sum(dim=1) - 1).clamp(min=0).sum().item())
    # what the fixed tree lets any exact kernel reach: the additions the
    # period needs over those the padded tree makes (cp - 1 a row)
    made = lambda planes: n * (mk._committee_pad(planes.shape[1]) - 1)
    ceilings = {"agg_g1": (adds_g1, made(sx)), "agg_g2": (adds_g2, made(gx))}
    paired = int((sm.any(dim=1) & gm.any(dim=1))[:SHARDS].sum().item())
    one_add = lambda xs, ys, m, fp2: lambda: mk.run_agg_plain(
        xs[:1, :2], ys[:1, :2], torch.ones_like(m[:1, :2]), fp2=fp2)
    row = lambda t: t[:1]
    g1_pt, g2_pt = mk.KNL * 4, 2 * mk.KNL * 4      # bytes of one point plane
    cases = {   # kernel, plain, (plain work unit, units), bytes moved
        "agg_g1": (agg1, agg1_p, (one_add(sx, sy, sm, False), adds_g1),
                   int(sm.sum().item()) * 2 * g1_pt + 3 * SHARDS * g1_pt),
        "agg_g2": (agg2, agg2_p, (one_add(gx, gy, gm, True), adds_g2),
                   int(gm.sum().item()) * 2 * g2_pt + 3 * SHARDS * g2_pt),
        "miller": (mil, mil_p, (lambda: mk.run_miller_plain(
                       tuple(map(row, sig)), tuple(map(row, h)),
                       tuple(map(row, pk))), paired),
                   paired * (nbytes(*sig, *h, *pk) // n + 6 * g2_pt)
                   + mk._MILLER_LINES.nbytes),
        "finalexp": (fe, fe_p, (lambda: mk.run_program_plain(nd[:1]),
                                paired),
                     paired * 2 * nbytes(nd) // n + mk._PROGRAM.nbytes),
    }
    results = {}
    for name, (kern, plain, (unit, units), moved) in cases.items():
        got = kern()
        want_limbs = plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, want_limbs)
        print(f"kernel {name}: max |kernel - plain| over limbs = {err} "
              f"(tolerance 0)", flush=True)
        if err != 0:
            fail(f"{name} disagrees with its plain version")
        macs = count_multiply_adds(
            mk, unit, karatsuba=name in ("finalexp", "agg_g2", "miller"))
        results[name] = dict(bound(macs * units, moved), max_abs_err=err,
                             units=units)
        if name == "miller":   # at four schoolbooks per Fp2 product too
            results[name]["four"] = bound(
                count_multiply_adds(mk, unit) * units, moved)
    verdict_k = mk.finalexp_is_one(f)
    with route.plain_versions():
        verdict_p = mk.finalexp_is_one(f)
    if not torch.equal(verdict_k, verdict_p):
        fail("finalexp verdicts differ from the plain version")
    for kind, prog in STEP_PROGRAMS.items():
        err = max_abs_err(mk.finalexp_kernel(nd, prog),
                          mk.run_program_plain(nd, prog))
        print(f"kernel finalexp on {len(prog)} {kind} steps at {n} rows: "
              f"max |kernel - plain| over limbs = {err} (tolerance 0)",
              flush=True)
        if err != 0:
            fail(f"finalexp disagrees with its plain version on {kind} "
                 f"steps")

    for kind, ops in MILLER_STEPS.items():
        err = max_abs_err(mk.miller_kernel(sig, h, pk, ops),
                          mk.run_miller_plain(sig, h, pk, ops))
        print(f"kernel miller on {len(ops)} {kind} steps at {n} rows: "
              f"max |kernel - plain| over limbs = {err} (tolerance 0)",
              flush=True)
        if err != 0:
            fail(f"miller disagrees with its plain version on {kind} steps")

    combs = {"_COMB_FP2": bn._COMB_FP2, "_COMB_FP2_SQR": bn._COMB_FP2_SQR,
             "_COMB": bn._COMB, "_LCOMB": bn._LCOMB,
             "identity": limb._IDENTITY}
    plans = {"fp_mul": bn.FP.mul_plan, "fp2_mul": bn._FP2_MUL,
             "fp2_sqr": bn._FP2_SQR, "fp12_mul": bn._FP12_MUL,
             "fp12_mul_line": bn._LINE_MUL}
    plan_names = {id(p): name for name, p in plans.items()}
    edge = check_tower_edges(bn, tower, conv, norm, route, plans, combs, dev,
                             range(25, norm.MAX_WIDTH + 1))
    cover = {"tower": TOWER_COVER, "conv": CONV_COVER,
             "norm": f"widths 25-{norm.MAX_WIDTH}, negative and "
                     f"±2^30.7 limbs, a partial block, leading dims"}
    for name in ("tower", "conv", "norm"):
        print(f"kernel {name}: max |kernel - plain| over limbs = "
              f"{edge[name]} (tolerance 0; {cover[name]})", flush=True)
        if edge[name] != 0:
            fail(f"{name} disagrees with its plain version")

    # -- the recompute path (no keys), counted ------------------------------
    backend = TorchSigBackend()
    for k in _build.KERNELS.values():
        k.launches = 0
    got = backend.bls_verify_committees(msgs, sig_rows, pk_rows)
    rec_launches = _build.launch_counts()
    print(f"recompute path: launches per audit {rec_launches}")
    if any(rec_launches[name] != 1 for name in mk.KERNELS):
        fail(f"the audit did not launch each audit kernel once: "
             f"{rec_launches}")
    if rec_launches["norm"] < 1:
        fail("the recompute audit launched no normalize kernel")
    if got != want:
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        fail(f"verdicts differ from the expected list at rows {bad}")
    with route.plain_versions():
        plain_got = bn.bls_aggregate_verify_committee_batch(*on_card)
    if plain_got.cpu()[:SHARDS].tolist() != got:
        fail("the plain versions on the card give other verdicts")
    print(f"recompute path: {sum(got)} of {SHARDS} rows verified, hostile "
          f"rows {', '.join(map(str, HOSTILE))} rejected; plain versions "
          f"agree")
    recompute_got = got

    # -- the precomp path (keys), counted: cold, then warm ------------------
    pbackend = TorchSigBackend()
    for k in _build.KERNELS.values():
        k.launches = 0
    got = pbackend.bls_verify_committees(msgs, sig_rows, pk_rows,
                                         pk_row_keys=keys)
    cold_launches = _build.launch_counts()
    cold_timing = pbackend.last_timing
    print(f"precomp path, cold: launches {cold_launches}, G2 bytes "
          f"{cold_timing['g2_wire_bytes']}, hit rows "
          f"{cold_timing['hit_rows']}")
    if got != want or got != recompute_got:
        fail("cold precomp verdicts differ from the expected list or the "
             "recompute path's")
    for name in ("agg_g1", "agg_g2", "tower", "norm", "finalexp"):
        if cold_launches[name] < 1:
            fail(f"the cold precomp audit launched no {name} kernel")
    for k in _build.KERNELS.values():
        k.launches = 0
    with TowerLaunches(tower, norm, plan_names) as warm_log:
        got = pbackend.bls_verify_committees(msgs, sig_rows, pk_rows,
                                             pk_row_keys=keys)
    warm_launches = _build.launch_counts()
    warm_timing = pbackend.last_timing
    pointful = sum(1 for r in pk_rows if r)
    print(f"precomp path, warm: launches {warm_launches}, G2 bytes "
          f"{warm_timing['g2_wire_bytes']}, hit rows "
          f"{warm_timing['hit_rows']} of {pointful} non-empty")
    if got != want:
        fail("warm precomp verdicts differ from the expected list")
    if not warm_timing["memo"] or warm_timing["g2_wire_bytes"] != 0 \
            or warm_timing["hit_rows"] != pointful:
        fail("the warm precomp audit missed the memo, shipped G2 bytes or "
             "missed a row")
    for name in ("agg_g1", "tower", "norm", "finalexp"):
        if warm_launches[name] < 1:
            fail(f"the warm precomp audit launched no {name} kernel")
    if cold_launches["conv"] or warm_launches["conv"]:
        fail("a tower product launched the conv kernel on its own")
    if warm_launches["agg_g2"] or warm_launches["miller"]:
        fail("the warm precomp audit ran the G2 sums or the Miller kernel")
    sample_err = check_samples(warm_log.samples, tower, norm, route)
    for name in ("tower", "norm"):
        shapes = sum(1 for key in warm_log.samples if key[0] == name)
        print(f"kernel {name}: max |kernel - plain| over limbs = "
              f"{sample_err[name]} (tolerance 0) on the warm audit's "
              f"inputs ({shapes} shapes)")
        if sample_err[name] != 0:
            fail(f"{name} disagrees with its plain version on the audit")

    # the same committees in another shard order: a new key tuple, so the
    # batch memo misses and every row's table is stacked from the LRU
    turn = lambda rows: rows[1:] + rows[:1]
    turned = (turn(msgs), turn(sig_rows), turn(pk_rows))
    for k in _build.KERNELS.values():
        k.launches = 0
    got = pbackend.bls_verify_committees(*turned, pk_row_keys=turn(keys))
    lru_launches = _build.launch_counts()
    lru_timing = pbackend.last_timing
    print(f"precomp path, warm from the LRU (shards in another order, the "
          f"batch memo missed): launches {lru_launches}, G2 bytes "
          f"{lru_timing['g2_wire_bytes']}, hit rows {lru_timing['hit_rows']} "
          f"of {pointful} non-empty")
    if got != turn(want):
        fail("warm precomp verdicts from the LRU differ from the expected "
             "list")
    if lru_timing["memo"] or lru_timing["g2_wire_bytes"] != 0 \
            or lru_timing["hit_rows"] != pointful:
        fail("the warm precomp audit from the LRU took the memo, shipped "
             "G2 bytes or missed a row")
    if lru_launches["agg_g2"] or lru_launches["miller"] \
            or lru_launches["finalexp"] != 1:
        fail("the warm precomp audit from the LRU ran the G2 sums or the "
             "Miller kernel, or not one final exponentiation")

    table, inf = bn.precompute_g2_lines(gx, gy, gm)
    fk, ok = bn.bls_committee_precomp_miller(hx, hy, sx, sy, sm, table, inf,
                                             hok)
    with route.plain_versions():
        table_p, inf_p = bn.precompute_g2_lines(gx, gy, gm)
        fp, ok_p = bn.bls_committee_precomp_miller(hx, hy, sx, sy, sm,
                                                   table_p, inf_p, hok)
        verdict_plain = bn.bls_committee_precomp_finalexp(fp, ok_p)
    err_table, err_f = max_abs_err(table, table_p), max_abs_err(fk, fp)
    print(f"precomp path: line tables {tuple(table.shape)} and f "
          f"{tuple(fk.shape)} against the plain route on the card: max "
          f"|kernel - plain| = {err_table} and {err_f}")
    if err_table or err_f or not torch.equal(inf, inf_p) \
            or not torch.equal(ok, ok_p):
        fail("the precomp tables or f differ from the plain route")
    if verdict_plain.cpu()[:SHARDS].tolist() != want:
        fail("the plain route's precomp verdicts differ from the expected "
             "list")
    print(f"precomp path: {sum(got)} of {SHARDS} rows verified cold and "
          f"warm, the same rows as the recompute path")

    # -- aggregate votes (bls_verify_aggregates), counted and timed ----------
    votes = aggregate_votes(bls, msgs, sig_rows, pk_rows, want)
    aggregates_phase("", bls, bn, route, _build, pbackend, votes, card)

    # -- times ---------------------------------------------------------------
    audit_s, marshal_s = [], []
    for _ in range(7):
        t0 = time.perf_counter()
        backend.bls_verify_committees(msgs, sig_rows, pk_rows)
        audit_s.append(time.perf_counter() - t0)
        marshal_s.append(backend.last_timing["marshal_s"])
    cold_s = []     # a real period's messages are new: hashing included
    for _ in range(3):
        bls.hash_to_g1.cache_clear()
        t0 = time.perf_counter()
        backend.bls_verify_committees(msgs, sig_rows, pk_rows)
        cold_s.append(time.perf_counter() - t0)
    plru_s = []     # two shard orders in turn: the memo misses every time
    for i in range(7):
        batch = (msgs, sig_rows, pk_rows, keys) if i % 2 == 0 \
            else turned + (turn(keys),)
        t0 = time.perf_counter()
        pbackend.bls_verify_committees(*batch[:3], pk_row_keys=batch[3])
        plru_s.append(time.perf_counter() - t0)
        if pbackend.last_timing["memo"] \
                or pbackend.last_timing["hit_rows"] != pointful:
            fail("an audit in another shard order took the memo or missed "
                 "a row")
    pwarm_s, pmarshal_s = [], []
    for _ in range(7):
        t0 = time.perf_counter()
        pbackend.bls_verify_committees(msgs, sig_rows, pk_rows,
                                       pk_row_keys=keys)
        pwarm_s.append(time.perf_counter() - t0)
        pmarshal_s.append(pbackend.last_timing["marshal_s"])
    psteady_s = []  # the notary's period: new messages, resident tables
    for _ in range(3):
        bls.hash_to_g1.cache_clear()
        t0 = time.perf_counter()
        pbackend.bls_verify_committees(msgs, sig_rows, pk_rows,
                                       pk_row_keys=keys)
        psteady_s.append(time.perf_counter() - t0)
    pcold_s, pcold_marshal_s = [], []   # new messages, a new backend
    for _ in range(3):
        bls.hash_to_g1.cache_clear()
        fresh = TorchSigBackend()
        t0 = time.perf_counter()
        fresh.bls_verify_committees(msgs, sig_rows, pk_rows,
                                    pk_row_keys=keys)
        pcold_s.append(time.perf_counter() - t0)
        pcold_marshal_s.append(fresh.last_timing["marshal_s"])

    def transfer():
        out = [torch.as_tensor(p, device=dev) for p in planes]
        torch.cuda.synchronize()
        return out

    transfer_ms = host_ms(transfer, 5)
    device_ms = host_ms(
        lambda: bn.bls_aggregate_verify_committee_batch(*on_card).cpu(), 5)
    bls.hash_to_g1.cache_clear()
    t0 = time.perf_counter()
    for m in msgs:
        bls.hash_to_g1(m)
    hash_ms = (time.perf_counter() - t0) * 1e3 / len(msgs)

    build = lambda: bn.precompute_g2_lines(gx, gy, gm)
    build_ms = host_ms(lambda: (build(), torch.cuda.synchronize()), 3)
    build_split = kernel_split(device_times(build)[0])
    print(f"time table build (precompute_g2_lines, {n} rows): host "
          f"{build_ms:.2f} ms with synchronize; device kernels under the "
          f"profiler {sum(build_split.values()):.2f} ms "
          f"({', '.join(f'{k} {v:.2f}' for k, v in build_split.items())}) "
          f"[{card}]")
    psig = mk.aggregate_proj(sx, sy, sm, fp2=False)
    loop = lambda: bn.miller_loop_precomp(psig, hx, hy, table)
    loop_ms = host_ms(lambda: (loop(), torch.cuda.synchronize()), 5)
    before = _build.launch_counts()
    loop()
    loop_counts = {name: count - before[name]
                   for name, count in _build.launch_counts().items()
                   if count != before[name]}
    products = 2 * len(bn._OPT_OPS) + int((bn._OPT_OPS == 0).sum()) + 2
    if sum(loop_counts.values()) > 300 or loop_counts.get("conv", 0) \
            or loop_counts.get("norm", 0) > 3 \
            or loop_counts.get("tower", 0) != products:
        fail(f"the Miller loop did not run each of its {products} tower "
             f"products as one tower launch: {loop_counts}")
    loop_dev, loop_wall = device_times(loop)
    loop_split = kernel_split(loop_dev)
    print(f"time Miller loop (precomp, {n} rows): host {loop_ms:.2f} ms "
          f"with synchronize; {sum(loop_counts.values())} kernel launches "
          f"({dict(loop_counts)}); under the profiler {loop_wall:.2f} ms "
          f"host, device kernels {sum(loop_split.values()):.2f} ms "
          f"({', '.join(f'{k} {v:.2f}' for k, v in loop_split.items())}; "
          f"{len(loop_dev)} kernel names) [{card}]")
    warm_dev, warm_wall = device_times(lambda: pbackend.bls_verify_committees(
        msgs, sig_rows, pk_rows, pk_row_keys=keys))
    warm_split = kernel_split(warm_dev)
    busy = sum(warm_split.values())
    pwarm_ms = statistics.median(pwarm_s) * 1e3
    split = ", ".join(f"{k} {v:.2f}" for k, v in warm_split.items())
    print(f"time precomp audit, warm: device kernels {busy:.2f} ms under "
          f"the profiler ({split}) against {pwarm_ms:.1f} ms unprofiled (host {warm_wall:.1f} ms "
          f"profiled): device idle share {1 - busy / pwarm_ms:.3f} "
          f"[{card}]")

    rec_dev, _ = device_times(
        lambda: backend.bls_verify_committees(msgs, sig_rows, pk_rows))
    rec_split = kernel_split(rec_dev)
    rec_busy = sum(rec_split.values())
    rec_ms = statistics.median(audit_s) * 1e3
    print(f"time recompute audit, warm: device kernels {rec_busy:.2f} ms "
          f"under the profiler ({', '.join(f'{k} {v:.2f}' for k, v in rec_split.items())}) "
          f"against {rec_ms:.1f} ms unprofiled: device idle share "
          f"{1 - rec_busy / rec_ms:.3f} [{card}]")

    kernels = []
    for name, (kern, plain, _, _) in cases.items():
        ms = cuda_ms(kern, 10)
        plain_ms = cuda_ms(plain, 1, queued=False)
        r = results[name]
        k = mk.KERNELS[name]
        print(f"time {name}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
              f"{r['multiply_adds']} int32 multiply-adds over {r['units']} "
              f"needed units, {r['bytes']} B) [{card}]")
        if name == "miller":
            four = r["four"]
            print(f"time miller: {r['bound_ms'] / ms:.1%} of its bound "
                  f"counted as the kernel computes (three schoolbooks per "
                  f"Fp2 product); at four schoolbooks per Fp2 product "
                  f"bound {four['bound_ms']:.4f} ms ({four['bound_by']}: "
                  f"{four['multiply_adds']} multiply-adds), "
                  f"{four['bound_ms'] / ms:.1%} [{card}]")
        if name in ceilings:
            need, tree = ceilings[name]
            print(f"time {name}: {r['bound_ms'] / ms:.1%} of its bound; "
                  f"the tree's ceiling {need} / {tree} = {need / tree:.1%} "
                  f"(additions the period needs over those the padded "
                  f"tree makes) [{card}]")
        kernels.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": rec_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
    kernel_ms = sum(k["ms"] for k in kernels)
    for kind, prog in STEP_PROGRAMS.items():
        step_us = cuda_ms(lambda: mk.finalexp_kernel(nd, prog),
                          10) * 1e3 / len(prog)
        macs = count_multiply_adds(
            mk, lambda: mk.run_program_plain(nd[:1], prog[:1]),
            karatsuba=True)
        step_bound_us = macs * n / INT32_MAD_PER_S * 1e6
        print(f"time finalexp per {kind} step ({len(prog)} steps, {n} rows, "
              f"one launch): kernel {step_us:.3f} µs per step; {macs} int32 "
              f"multiply-adds per step per row ({macs * n} for {n} rows), "
              f"bound {step_bound_us:.4f} µs per step [{card}]")

    for kind, ops in MILLER_STEPS.items():
        stream_ms = cuda_ms(lambda: mk.miller_kernel(sig, h, pk, ops), 10)
        # one step's work: a stream of two steps less a stream of one
        # (the preamble counts in both)
        row1 = lambda k: mk.run_miller_plain(
            tuple(map(row, sig)), tuple(map(row, h)), tuple(map(row, pk)),
            ops[:k])
        macs = count_multiply_adds(mk, lambda: row1(2), karatsuba=True) \
            - count_multiply_adds(mk, lambda: row1(1), karatsuba=True)
        step_bound_us = macs * n / INT32_MAD_PER_S * 1e6
        print(f"time miller per {kind} step ({len(ops)} steps, {n} rows, "
              f"one launch, preamble included): kernel "
              f"{stream_ms * 1e3 / len(ops):.3f} µs per step; {macs} int32 "
              f"multiply-adds per step per row, bound {step_bound_us:.4f} "
              f"µs per step [{card}]")

    warm_counts = warm_log.counts
    tower_keys = sorted((k for k in warm_counts if k[0] == "tower"),
                        key=lambda k: -warm_counts[k])
    tower_bound = sum(tower_work(k, warm_log.samples[k][0])["bound_ms"]
                      * warm_counts[k] for k in tower_keys)
    for key in tower_keys:
        sample = warm_log.samples[key]
        ms = cuda_ms(lambda: tower.tower_kernel(*sample), 50)
        with route.plain_versions():
            plain_ms = cuda_ms(lambda: sample[0].plain(*sample[1:]), 5,
                               queued=False)
        r = tower_work(key, sample[0])
        print(f"time tower: kernel {ms:.4f} ms per launch at {key[1]} "
              f"{key[2]} x {key[3]} ({warm_counts[key]} launches per warm "
              f"audit), plain route {plain_ms:.3f} ms, bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']}: "
              f"{r['multiply_adds']} multiply-adds, {r['bytes']} B) [{card}]")
        if key == tower_keys[0]:
            kernels.append({
                "name": "tower", "route": "cuda",
                "source": tower.KERNEL.source,
                "replaces": tower.KERNEL.replaces,
                "launches": warm_launches["tower"],
                "max_abs_err": max(edge["tower"], sample_err["tower"]),
                "ms": ms, "plain_ms": plain_ms, "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None})
    print(f"time tower: per warm audit {warm_launches['tower']} launches, "
          f"{warm_split['tower_kernel']:.2f} ms summed kernel time "
          f"(profiler), bound {tower_bound:.4f} ms [{card}]")

    # conv and normalize on their own, at fixed shapes: the line product
    # (x read in place along the six outputs) and (1344, 25)
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    lx = torch.randint(0, 1 << 12, (n, 1, 3, 2, 25), generator=gen,
                       device=dev, dtype=torch.int32)
    ly = torch.randint(0, 1 << 12, (n, 6, 3, 2, 25), generator=gen,
                       device=dev, dtype=torch.int32)
    nz = torch.randint(-(1 << 28), 1 << 28, (12 * n, 25), generator=gen,
                       device=dev, dtype=torch.int32)
    nz[:, -1] = nz[:, -1].abs()
    standalone = (
        ("conv", ("conv", "_LCOMB", tuple(lx.shape), tuple(ly.shape)),
         (lx, ly, bn._LCOMB), conv.conv_kernel, conv.pair_conv_combine_plain,
         lambda key: conv_work(key, bn._LCOMB)),
        ("norm", ("norm", tuple(nz.shape)), (bn.FP, nz),
         norm.normalize_kernel, norm.normalize_plain, norm_work))
    for name, key, sample, call, plain_call, work in standalone:
        err = max_abs_err(call(*sample), plain_call(*sample))
        if err:
            fail(f"{name} disagrees with its plain version at {key[1:]}")
        ms = cuda_ms(lambda: call(*sample), 50)
        plain_ms = cuda_ms(lambda: plain_call(*sample), 5, queued=False)
        r = work(key)
        per_audit = [work(k) for k in warm_counts if k[0] == name
                     for _ in range(warm_counts[k])]
        audit_bound = sum(w["bound_ms"] for w in per_audit)
        print(f"time {name}: kernel {ms:.4f} ms per launch at {key[1:]}, "
              f"plain {plain_ms:.3f} ms, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}: {r['multiply_adds']} multiply-adds, "
              f"{r['bytes']} B); per warm audit: {warm_launches[name]} "
              f"launches, {warm_split[name + '_kernel']:.2f} ms summed "
              f"kernel time (profiler), bound {audit_bound:.4f} ms; cold "
              f"audit {cold_launches[name]} launches [{card}]")
        kernel = _build.KERNELS[name]
        kernels.append({
            "name": name, "route": "cuda", "source": kernel.source,
            "replaces": kernel.replaces, "launches": warm_launches[name],
            "max_abs_err": max(edge[name], sample_err.get(name, 0), err),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})

    votes = SHARDS * COMMITTEE
    steady_ms = statistics.median(psteady_s) * 1e3
    lru_ms = statistics.median(plru_s) * 1e3
    print(f"time precomp audit, warm without the batch memo (two shard "
          f"orders in turn, every table stacked from the LRU): median "
          f"{lru_ms:.1f} ms of {len(plru_s)}, against {pwarm_ms:.1f} ms "
          f"with the memo [{card}]")
    print(f"time precomp audit, a period of new messages with resident "
          f"tables (the notary's steady state): median {steady_ms:.1f} ms "
          f"of {len(psteady_s)}, {votes / steady_ms * 1e3:.0f} votes/s, "
          f"hash_to_g1 {hash_ms:.3f} ms per message (host); "
          f"cold audit's host marshal with hashing and the miss rows' G2 "
          f"planes median {statistics.median(pcold_marshal_s) * 1e3:.1f} "
          f"ms [{card}]")
    for label, cold, warm, marshal in (
            ("recompute (no keys)", cold_s, audit_s, marshal_s),
            ("precomp (keys)", pcold_s, pwarm_s, pmarshal_s)):
        cold_ms = statistics.median(cold) * 1e3
        warm_ms = statistics.median(warm) * 1e3
        print(f"time audit, {label}: cold period (messages hashed"
              f"{', tables built' if 'precomp' in label else ''}) median "
              f"{cold_ms:.1f} ms of {len(cold)}, {votes / cold_ms * 1e3:.0f} "
              f"votes/s; warm median {warm_ms:.1f} ms of {len(warm)}, "
              f"{votes / warm_ms * 1e3:.0f} votes/s, host marshal "
              f"{statistics.median(marshal) * 1e3:.1f} ms [{card}]")
    print(f"time recompute stages, warm: transfer {transfer_ms:.2f} ms, "
          f"device path with pull {device_ms:.2f} ms (audit kernels "
          f"{kernel_ms:.2f} ms, glue and pull {device_ms - kernel_ms:.2f} "
          f"ms); hash_to_g1 {hash_ms:.3f} ms per message (host) [{card}]")
    marks = [("build and steps 1-8", time.perf_counter())]
    kernels += run_exact_phase(args.seed)
    marks.append(("9", time.perf_counter()))
    kernels += vote_phase(card, args.seed)
    marks.append(("10", time.perf_counter()))
    multiproof_phase(card, args.seed)
    marks.append(("11", time.perf_counter()))
    kernels += replay_phase(card, args.seed)
    marks.append(("12", time.perf_counter()))
    finish_roots_phase(roots)
    stressed = stress_phase(card, args.seed, stress_build)
    marks.append(("13", time.perf_counter()))
    members = notary_phase(card, args.seed)
    marks.append(("14", time.perf_counter()))
    node_phase(card, members)
    marks.append(("15", time.perf_counter()))
    das_phase(card, members)
    marks.append(("16", time.perf_counter()))
    vote, medians = serving_phase(
        card, args.seed, (msgs, sig_rows, pk_rows, keys, want), members)
    marks.append(("17", time.perf_counter()))
    topology_phase(card, (msgs, sig_rows, pk_rows, keys, want), vote,
                   medians)
    marks.append(("18", time.perf_counter()))
    mesh_phase(card, (msgs, sig_rows, pk_rows, keys, want), stressed)
    marks.append(("19", time.perf_counter()))
    prev, parts = t_smoke, []
    for name, t in marks:
        parts.append(f"{name} {t - prev:.1f}")
        prev = t
    print(f"smoke: {time.perf_counter() - t_smoke:.1f} s in all, the build "
          f"included (by step, s: {', '.join(parts)})", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
