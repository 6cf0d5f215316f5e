"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Imports nothing of JAX, so the same file runs on a machine with an
NVIDIA card and no JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider

Where there is no card the `cuda` tests skip with a reason; the wrapper
checks below run everywhere. Workloads are protocol-true committees,
signatures and DAS samples made with the port's own scalar crypto from
fixed seeds."""

import functools

import numpy as np
import pytest
import torch

import torch_das_rows
import torch_poly_rows
from gethsharding_tpu_torch.crypto import bn256 as bls
from gethsharding_tpu_torch.crypto import secp256k1 as ecdsa
from gethsharding_tpu_torch.crypto.keccak import keccak256
from gethsharding_tpu_torch.das import poly_proofs
from gethsharding_tpu_torch.das import proofs as das
from gethsharding_tpu_torch.ops import _build, conv, limb, norm, route, tower
from gethsharding_tpu_torch.ops import bn256 as bn
from gethsharding_tpu_torch.ops import megakernels as mk
from gethsharding_tpu_torch.ops import secp256k1 as secp
from gethsharding_tpu_torch.sigbackend.dispatch import (TorchSigBackend,
                                                     committee_planes)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")
    return torch.device("cuda")


def _canon(rng, shape, device):
    return torch.as_tensor(rng.integers(0, 1 << 12, shape + (25,))
                           .astype(np.int32), device=device)


def _committee_period(shards: int, votes: int):
    """sk_j = j + 1; row s signs message s; hostile rows 1 (forged vote)
    and 2 (empty committee) are rejections."""
    msgs = [b"cuda-test-%d" % s for s in range(shards)]
    pks = [bls.g2_mul(j + 1, bls.G2_GEN) for j in range(votes)]
    sig_rows = [[bls.g1_mul(j + 1, bls.hash_to_g1(m)) for j in range(votes)]
                for m in msgs]
    pk_rows = [list(pks) for _ in msgs]
    sig_rows[1][0] = bls.g1_add(sig_rows[1][0], bls.G1_GEN)
    sig_rows[2], pk_rows[2] = [], []
    want = [s not in (1, 2) for s in range(shards)]
    return msgs, sig_rows, pk_rows, want


def test_kernel_wrappers_refuse_cpu_tensors():
    before = {n: k.launches for n, k in mk.KERNELS.items()}
    x = torch.zeros((2, 3, 25), dtype=torch.int32)
    m = torch.ones((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        mk.agg_kernel(x, x, m, fp2=False)
    with pytest.raises(ValueError, match="CUDA"):
        mk.finalexp_kernel(torch.zeros((2, 2, 6, 2, 25), dtype=torch.int32))
    fp = torch.zeros((2, 25), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        mk.miller_kernel((fp, fp, fp), (fp, fp), (x[:, :2],) * 3)
    assert {n: k.launches for n, k in mk.KERNELS.items()} == before


def test_tower_and_conv_kernels_refuse_22_limb_operands():
    """In the wide form (this module's) the kernels take 25-limb operands
    only; the exact form's tower runs in a process of that form."""
    before = _build.launch_counts()
    u = torch.zeros((3, 1, 2, 22), dtype=torch.int32)
    with pytest.raises(ValueError, match="wide limb form takes 25"):
        tower.tower_kernel(bn._FP2_MUL, u, u)
    with pytest.raises(ValueError, match="wide limb form takes 25"):
        conv.conv_kernel(u, u, bn._COMB_FP2)
    assert _build.launch_counts() == before


def test_tower_wrappers_refuse_cpu_tensors():
    before = _build.launch_counts()
    x = torch.zeros((3, 1, 2, 25), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        conv.conv_kernel(x, x, bn._COMB_FP2)
    with pytest.raises(ValueError, match="CUDA"):
        norm.normalize_kernel(bn.FP, torch.zeros((3, 49), dtype=torch.int32))
    with pytest.raises(ValueError, match="width"):
        norm.normalize_kernel(bn.FP, torch.zeros((3, 53), dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        route.use_kernel(torch.zeros(2, device="meta"))
    f = torch.zeros((3, 6, 2, 25), dtype=torch.int32)
    for plan, u, v in ((bn._FP12_MUL, f, f), (bn._LINE_MUL, f[:, :3], f),
                       (bn._FP2_MUL, x, x), (bn.FP.mul_plan, x[..., :1, :1, :],
                                             x[..., :1, :1, :])):
        with pytest.raises(ValueError, match="CUDA"):
            tower.tower_kernel(plan, u, v)
    assert _build.launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["_COMB_FP2", "_COMB_FP2_SQR", "_COMB",
                                  "_LCOMB", "identity"])
def test_conv_kernel_equals_plain(cuda, name):
    comb = limb._IDENTITY if name == "identity" else getattr(bn, name)
    G, A, B = comb.shape[:3]
    rng = np.random.default_rng(92)
    for lead in ((113,), (3, 37)):   # a partial block, extra leading dims
        x, y = _canon(rng, lead + (G, A), cuda), _canon(rng, lead + (G, B), cuda)
        assert torch.equal(conv.pair_conv_combine(x, y, comb),
                           conv.pair_conv_combine_plain(x, y, comb))
    const = _canon(rng, (G, B), cuda)   # a constant against the batch
    assert torch.equal(conv.pair_conv_combine(x, const, comb),
                       conv.pair_conv_combine_plain(x, const, comb))


def test_row_walk_refuses_rows_past_32_bits():
    """The kernels index batch rows in 32 bits; the row plan refuses more
    (shapes only: nothing is allocated)."""
    block = (1, 1, 25)
    lead, n = conv.broadcast_plan((2, 3) + block, (75, 25, 25, 25, 1),
                                  block, (25, 25, 1))[:2]
    assert lead == (2, 3) and n == 6
    with pytest.raises(ValueError, match="2\\^31"):
        conv.broadcast_plan((1 << 16, 1 << 15) + block,
                            (25 << 15, 25, 25, 25, 1), block, (25, 25, 1))


# each product: its plan, and its two operands' point shapes (u, v)
_TOWER = {"fp_mul": (lambda: bn.FP.mul_plan, (), ()),
          "fp2_mul": (lambda: bn._FP2_MUL, (2,), (2,)),
          "fp2_sqr": (lambda: bn._FP2_SQR, (2,), (2,)),
          "fp12_mul": (lambda: bn._FP12_MUL, (6, 2), (6, 2)),
          "fp12_sqr": (lambda: bn._FP12_MUL, (6, 2), (6, 2)),
          "fp12_mul_line": (lambda: bn._LINE_MUL, (3, 2), (6, 2))}


def _kernel_form(t, point):
    """(..., *point, 25) -> the tower kernel's (..., G, A, 25) operand."""
    lead = t.shape[:t.dim() - 1 - len(point)]
    return t.reshape(lead + (1,) * (2 - len(point)) + tuple(point) + (25,))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_TOWER))
def test_tower_kernel_equals_plain(cuda, name):
    """One tower launch per product against the plain route on the card:
    a partial block, leading dims with a broadcast middle dim, a
    broadcast constant, all-4095 limbs."""
    plan_of, us, vs = _TOWER[name]
    plan = plan_of()
    rng = np.random.default_rng(94)
    for lu, lv in (((113,), (113,)), ((3, 1), (3, 37)), ((112,), ()),
                   ((4, 29), (4, 29))):
        u = _kernel_form(_canon(rng, lu + us, cuda), us)
        v = _kernel_form(_canon(rng, lv + vs, cuda), vs)
        if lu == (4, 29):
            u, v = torch.full_like(u, 4095), torch.full_like(v, 4095)
        if name.endswith("sqr"):
            v = u
        before = tower.KERNEL.launches
        got = tower.tower_kernel(plan, u, v)
        assert tower.KERNEL.launches == before + 1
        with route.plain_versions():
            want = plan.plain(u, v)
        assert torch.equal(got, want), (name, lu, lv)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [25, 26, 49, 52])
def test_norm_kernel_equals_plain(cuda, width):
    rng = np.random.default_rng(93)
    z = rng.integers(-(1 << 30), 1 << 30, (300, width))
    z[:, -1] = np.abs(z[:, -1]) + (1 << 29)    # value >= 0
    z = torch.as_tensor(z.astype(np.int32), device=cuda)
    assert torch.equal(bn.FP.normalize(z.reshape(3, 100, width)),
                       norm.normalize_plain(bn.FP, z).reshape(3, 100, 25))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [22, 25, 43, 49, 52])
def test_norm_exact_kernel_equals_plain(cuda, width):
    """The exact-form branch of csrc/norm.cu (22 output limbs), launched
    from this wide-form process through its `form` argument."""
    rng = np.random.default_rng(94)
    edge = int(2 ** 30.7) - 1
    z = rng.integers(-edge, edge + 1, (301, width))
    z[:, -1] = np.abs(z[:, -1]) + (1 << 29)    # value >= 0
    z[:4] = np.where(rng.integers(0, 2, (4, width)) == 1, edge, -edge)
    z[:4, -1] = edge                           # the bound edge
    z[4] = -1
    z[4, -1] = 1
    z = torch.as_tensor(z.astype(np.int32), device=cuda)
    before = norm.KERNEL.launches
    got = norm.normalize_kernel(bn.FP, z, form="exact")
    assert norm.KERNEL.launches == before + 1
    assert torch.equal(got, norm.normalize_plain(bn.FP, z, form="exact"))
    assert torch.equal(got.cpu(), norm.normalize_plain(bn.FP, z.cpu(),
                                                       form="exact"))


def test_carry_probe_refuses_what_the_kernel_does_not_take():
    acc = torch.zeros((3, 22), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        norm.carry_probe(acc, 24)
    with pytest.raises(ValueError, match="into 25"):
        norm.carry_probe(acc, 25)
    with pytest.raises(ValueError, match="carry of 23 limbs"):
        norm.carry_probe(torch.zeros((3, 23), dtype=torch.int32), 24)
    with pytest.raises(ValueError, match="CUDA"):
        norm.tail_probe(bn.FP, acc)
    with pytest.raises(ValueError, match="tail of 25 limbs"):
        norm.tail_probe(bn.FP, torch.zeros((3, 25), dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("nout", norm.CARRY_WIDTHS)
def test_norm_carry_probe_equals_ripple(cuda, nout):
    """The exact ladder's carry alone on the card (`gs_norm_carry`) on the
    crafted rows of `norm.carry_edge_rows` and 1,000 seeded ones, a
    partial block among them: equal to `limb.carry` with the carry off
    the top dropped, and to a Python integer ripple on the crafted rows."""
    acc = norm.carry_edge_rows(seed=nout, random_rows=1000 + nout)
    got = norm.carry_probe(acc.to(cuda), nout)
    want = norm.carry_plain(acc, nout)
    assert torch.equal(got.cpu(), want)
    for row, limbs in zip(acc[:32].tolist(), want[:32].tolist()):
        v = sum(x << (12 * j) for j, x in enumerate(row)) % (1 << 12 * nout)
        assert limbs == [(v >> (12 * j)) & 4095 for j in range(nout)]


@pytest.mark.cuda
def test_norm_tail_probe_equals_plain(cuda):
    """The exact ladder's tail alone on the card (`gs_norm_tail`) on the
    crafted rows and 1,001 seeded ones: equal to `norm.tail_plain`."""
    acc = norm.carry_edge_rows(seed=4, random_rows=1001)
    got = norm.tail_probe(bn.FP, acc.to(cuda))
    assert torch.equal(got.cpu(), norm.tail_plain(bn.FP, acc))


@pytest.mark.cuda
def test_norm_exact_kernel_on_crafted_rows(cuda):
    """The crafted carry rows as 22-limb accumulators through the exact
    normalize on the card."""
    z = norm.carry_edge_rows(seed=3, random_rows=203)
    got = norm.normalize_kernel(bn.FP, z.to(cuda), form="exact")
    assert torch.equal(got.cpu(),
                       norm.normalize_plain(bn.FP, z, form="exact"))


@pytest.mark.cuda
@pytest.mark.parametrize("fp2", [False, True])
@pytest.mark.parametrize("n", [1, 112, 300])
@pytest.mark.parametrize("cdim", [1, 37, 144, 300])
def test_agg_kernel_equals_plain(cuda, fp2, n, cdim):
    """One launch per sum, the plain version's limbs, from 2 to 512 slots
    (one block per row; two for G2 at 512, the last adding the partials),
    on quasi-canonical limbs with slots of every limb 4095, 4160 or -1, a
    mask with holes, an all-off row and an all-on row."""
    rng = np.random.default_rng(91 + cdim)
    shape = (n, cdim) + ((2,) if fp2 else ()) + (25,)
    xs = rng.integers(-1, (1 << 12) + 65, shape).astype(np.int32)
    ys = rng.integers(-1, (1 << 12) + 65, shape).astype(np.int32)
    for j, limb in enumerate((4095, (1 << 12) + 64, -1)):
        xs[:, j::7] = limb
        ys[:, (j + 3)::7] = limb
    mask = rng.integers(0, 2, (n, cdim)).astype(np.int32)
    mask[0] = 1
    if n > 2:
        mask[n // 2] = 0
    xs, ys, mask = (torch.as_tensor(a, device=cuda) for a in (xs, ys, mask))
    kernel = mk.KERNELS["agg_g2" if fp2 else "agg_g1"]
    before = kernel.launches
    got = mk.agg_kernel(xs, ys, mask, fp2=fp2)
    assert kernel.launches == before + 1
    want = mk.run_agg_plain(xs, ys, mask.bool(), fp2=fp2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("fp2", [False, True])
def test_agg_kernel_splits_rows_over_blocks(cuda, fp2):
    """At 1,000 slots (1,024 after padding) a row's stack outgrows one
    block's shared memory: G1 splits it over 2 blocks, G2 over 4, and the
    row's last block adds the partials, in one launch, with the plain
    version's limbs on 3 rows."""
    rng = np.random.default_rng(97)
    n, cdim = 3, 1000
    shape = (n, cdim) + ((2,) if fp2 else ()) + (25,)
    xs = rng.integers(-1, (1 << 12) + 65, shape).astype(np.int32)
    ys = rng.integers(-1, (1 << 12) + 65, shape).astype(np.int32)
    mask = rng.integers(0, 2, (n, cdim)).astype(np.int32)
    mask[0] = 1
    xs, ys, mask = (torch.as_tensor(a, device=cuda) for a in (xs, ys, mask))
    assert mk.agg_blocks(1024, fp2) == (4 if fp2 else 2)
    kernel = mk.KERNELS["agg_g2" if fp2 else "agg_g1"]
    before = kernel.launches
    got = mk.agg_kernel(xs, ys, mask, fp2=fp2)
    assert kernel.launches == before + 1
    want = mk.run_agg_plain(xs, ys, mask.bool(), fp2=fp2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_miller_and_finalexp_kernels_equal_plain(cuda):
    msgs, sig_rows, pk_rows, want = _committee_period(5, 3)
    hx, hy, _ = bn.g1_to_limbs([bls.hash_to_g1(m) for m in msgs])
    sx, sy, sm = bn.g1_committee_to_limbs(sig_rows, 3)
    gx, gy, gm = bn.g2_committee_to_limbs(pk_rows, 3)
    t = lambda a: torch.as_tensor(a, device=cuda)
    sig = mk.aggregate_proj(t(sx), t(sy), t(sm), fp2=False)
    pk = mk.aggregate_proj(t(gx), t(gy), t(gm), fp2=True)
    h = (t(hx), t(hy))
    f = mk.miller_kernel(sig, h, pk)
    assert torch.equal(f, mk.run_miller_plain(sig, h, pk))
    f = bn.FP.normalize(f)
    nd = torch.stack([bn.fp12_conj(f), bn.FP.normalize(f)], dim=1)
    got = mk.finalexp_kernel(nd.contiguous())
    assert torch.equal(got, mk.run_program_plain(nd))
    inf = (bn.FP.is_zero(sig[2]) | bn.fp2_is_zero(pk[2])).tolist()
    assert [v and not i for v, i in
            zip(mk.finalexp_is_one(f).tolist(), inf)] == want


# a short final-exponentiation program (op, a, b, d) ending in the result
# register 13: products with a square and an aliased destination, the
# three Frobenius maps, swaps (0 = mul, 1 = swap, 2 = frob_b, 3 = copy)
_FE_MIXED = [(2, 0, 2, 4), (0, 4, 0, 0), (1, 0, 0, 4), (0, 0, 0, 13),
             (0, 13, 4, 13), (2, 13, 3, 13), (2, 13, 1, 13), (1, 13, 0, 13),
             (3, 13, 0, 5), (0, 5, 13, 13)]


def _quasi(rng, shape, device):
    """Quasi-canonical limbs in [-1, 4160], as the relaxed normalize
    leaves them."""
    return torch.as_tensor(rng.integers(-1, (1 << 12) + 65, shape + (25,))
                           .astype(np.int32), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 112, 113])
def test_finalexp_kernel_equals_plain_at_rows(cuda, n):
    """The whole program, one launch, limb for limb (tolerance 0): one row,
    the audit's 112, and one past a whole number of 112."""
    nd = _quasi(np.random.default_rng(96), (n, 2, 6, 2), cuda)
    before = mk.KERNELS["finalexp"].launches
    got = mk.finalexp_kernel(nd)
    assert mk.KERNELS["finalexp"].launches == before + 1
    assert torch.equal(got, mk.run_program_plain(nd))


@pytest.mark.cuda
def test_finalexp_kernel_runs_a_synthetic_program(cuda):
    """The kernel takes its program as an argument: a short mixed one
    against the plain loop of `_apply_op`, random and all-4160 limbs."""
    rng = np.random.default_rng(97)
    for nd in (_quasi(rng, (7, 2, 6, 2), cuda),
               torch.full((3, 2, 6, 2, 25), (1 << 12) + 64, dtype=torch.int32,
                          device=cuda)):
        assert torch.equal(mk.finalexp_kernel(nd, _FE_MIXED),
                           mk.run_program_plain(nd, _FE_MIXED))


def _miller_inputs(rng, n, device):
    return (tuple(_canon(rng, (n,), device) for _ in range(3)),
            (_canon(rng, (n,), device), _canon(rng, (n,), device)),
            tuple(_canon(rng, (n, 2), device) for _ in range(3)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 112, 300])
def test_miller_kernel_equals_plain_at_rows(cuda, n):
    """The audit's 88-step stream at 1 to 300 rows (one block per row),
    one launch, limb for limb."""
    sig, h, pk = _miller_inputs(np.random.default_rng(600 + n), n, cuda)
    kernel = mk.KERNELS["miller"]
    before = kernel.launches
    got = mk.miller_kernel(sig, h, pk)
    assert kernel.launches == before + 1
    assert torch.equal(got, mk.run_miller_plain(sig, h, pk))


# short Miller op streams (0 = DBL, 1-4 = ADD with the candidate +Q, -Q,
# pi Q, -pi^2 Q); step i takes line i of the generator-line table
_MILLER_STREAMS = {
    "dbl": [0], "add_q": [1], "add_neg_q": [2], "add_pi_q": [3],
    "add_neg_pi2_q": [4], "dbl_add_dbl": [0, 1, 0],
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_MILLER_STREAMS))
def test_miller_kernel_runs_short_streams(cuda, name):
    sig, h, pk = _miller_inputs(np.random.default_rng(700), 7, cuda)
    ops = _MILLER_STREAMS[name]
    assert torch.equal(mk.miller_kernel(sig, h, pk, ops),
                       mk.run_miller_plain(sig, h, pk, ops))


@pytest.mark.cuda
def test_finalexp_launches_once_per_audit(cuda):
    """One final-exponentiation launch per audit: recompute, precomp cold,
    precomp warm."""
    msgs, sig_rows, pk_rows, want = _committee_period(4, 3)
    keys = [("fe-count", s) for s in range(len(msgs))]
    backend = TorchSigBackend()
    for kw in ({}, {"pk_row_keys": keys}, {"pk_row_keys": keys}):
        before = _build.launch_counts()["finalexp"]
        assert backend.bls_verify_committees(msgs, sig_rows, pk_rows,
                                             **kw) == want
        assert _build.launch_counts()["finalexp"] == before + 1


@pytest.mark.cuda
def test_audit_on_card_launches_four_kernels(cuda):
    msgs, sig_rows, pk_rows, want = _committee_period(6, 4)
    for k in mk.KERNELS.values():
        k.launches = 0
    assert TorchSigBackend().bls_verify_committees(
        msgs, sig_rows, pk_rows) == want
    assert {n: k.launches for n, k in mk.KERNELS.items()} == {
        "agg_g1": 1, "agg_g2": 1, "miller": 1, "finalexp": 1}
    planes = [torch.as_tensor(a, device=cuda)
              for a in committee_planes(msgs, sig_rows, pk_rows)]
    with route.plain_versions():
        plain = bn.bls_aggregate_verify_committee_batch(*planes)
    assert plain.cpu()[:len(msgs)].tolist() == want


@pytest.mark.cuda
def test_precomp_audit_on_card(cuda):
    msgs, sig_rows, pk_rows, want = _committee_period(6, 4)
    keys = [("cuda-test", s) for s in range(len(msgs))]
    backend = TorchSigBackend()
    assert backend.bls_verify_committees(msgs, sig_rows, pk_rows,
                                         pk_row_keys=keys) == want
    for k in _build.KERNELS.values():
        k.launches = 0
    assert backend.bls_verify_committees(msgs, sig_rows, pk_rows,
                                         pk_row_keys=keys) == want
    warm = backend.last_timing
    assert warm["g2_wire_bytes"] == 0 and warm["hit_rows"] == 5
    counts = _build.launch_counts()
    assert counts["miller"] == counts["agg_g2"] == 0
    assert counts["tower"] > 0 and counts["norm"] > 0
    assert counts["conv"] == 0   # every product is one tower launch
    assert counts["agg_g1"] == counts["finalexp"] == 1
    planes = [torch.as_tensor(a, device=cuda)
              for a in committee_planes(msgs, sig_rows, pk_rows)]
    hx, hy, sx, sy, sm, gx, gy, gm, hok = planes
    def run():
        table, inf = bn.precompute_g2_lines(gx, gy, gm)
        f, ok = bn.bls_committee_precomp_miller(hx, hy, sx, sy, sm, table,
                                                inf, hok)
        return table, inf, f, ok

    routes = [run()]
    with route.plain_versions():
        routes.append(run())
    for got, plain in zip(*routes):
        assert torch.equal(got, plain)


@pytest.mark.cuda
def test_aggregates_on_card(cuda):
    """`bls_verify_aggregates`: one Miller and one final-exponentiation
    launch per call, the plain versions' verdicts."""
    msgs, sig_rows, pk_rows, want = _committee_period(4, 3)
    agg_sigs = [functools.reduce(bls.g1_add, row, None) for row in sig_rows]
    agg_pks = [functools.reduce(bls.g2_add, row, None) for row in pk_rows]
    backend = TorchSigBackend()
    for k in _build.KERNELS.values():
        k.launches = 0
    assert backend.bls_verify_aggregates(msgs, agg_sigs, agg_pks) == want
    counts = {n: c for n, c in _build.launch_counts().items() if c}
    assert counts.get("miller") == counts.get("finalexp") == 1
    assert not counts.get("agg_g1") and not counts.get("agg_g2")
    planes = [bn.g1_to_limbs([bls.hash_to_g1(m) for m in msgs]),
              bn.g1_to_limbs(agg_sigs), bn.g2_to_limbs(agg_pks)]
    (hx, hy, hok), (sx, sy, sok), (px, py, pok) = planes
    args = [torch.as_tensor(a, device=cuda)
            for a in (hx, hy, sx, sy, px, py, hok & sok & pok)]
    got = bn.bls_verify_aggregate_batch(*args)
    with route.plain_versions():
        plain = bn.bls_verify_aggregate_batch(*args)
    assert torch.equal(got, plain) and got.cpu().tolist() == want


@pytest.mark.cuda
def test_multiproofs_on_card(cuda):
    """`das_verify_multiproofs` on the hostile and infinity rows: one
    Miller and one final-exponentiation launch and no other kernel but
    the normalizes between them, the verdicts of the port's scalar
    `verify_multiproofs` and of the plain versions on the same planes."""
    names, rows, known = torch_poly_rows.hostile_rows()
    cols = torch_poly_rows.columns(rows)
    want = poly_proofs.verify_multiproofs(*cols)
    assert want == list(known)
    backend = TorchSigBackend()
    for k in _build.KERNELS.values():
        k.launches = 0
    assert backend.das_verify_multiproofs(*cols) == want
    counts = {n: c for n, c in _build.launch_counts().items()
              if c and n != "norm"}
    assert counts == {"miller": 1, "finalexp": 1}
    assert backend.last_timing["launches"]["miller"] == 1
    st = poly_proofs.marshal_multiproofs(*cols, backend.last_wire["bucket"])
    args = [torch.as_tensor(st[k], device=cuda) for k in poly_proofs.PLANES]
    with route.plain_versions():
        plain = bn.bls_verify_aggregate_batch(*args)
    assert plain.cpu().tolist()[:len(rows)] == want


# == the vote phase: secp256k1 recovery and DAS samples ======================


@functools.lru_cache(maxsize=None)
def _signed(i: int):
    priv = int.from_bytes(keccak256(b"cuda-vote-%d" % i), "big") % ecdsa.N
    digest = keccak256(b"cuda-vote-msg-%d" % i)
    return priv, digest, ecdsa.sign(digest, priv)


def _recovery_planes(n: int, device):
    """n kernel rows cycling through 8 valid signatures and the hostile
    rows of tests/test_torch_ecrecover.py::_hostile_rows: r = 0, s = n,
    recid 2, R = G, a tampered digest and valid False, r = p - 1,
    r = 2^256 - 1, s = 2^256 - 1, digests 0, n and 2^256 - 1, ladders
    whose accumulator meets its addend (G + R at R = G, R at R = 2G) or
    its negation (R at R = -2G), a key at infinity, r = n, s = 0, an r
    with no curve point, recid 5 and R = -G; (e, r, s, recid, valid) on
    `device`. Row i depends on i alone."""
    N, gx, gy_parity = ecdsa.N, ecdsa.GX, ecdsa.GY & 1
    two_g = ecdsa.point_add((ecdsa.GX, ecdsa.GY), (ecdsa.GX, ecdsa.GY))
    no_root = 5   # the smallest x >= 5 with x^3 + 7 not a square mod p
    while pow((no_root ** 3 + 7) % ecdsa.P, (ecdsa.P - 1) // 2,
              ecdsa.P) == 1:
        no_root += 1
    rows = []
    for i in range(n):
        _, digest, sig = _signed(i % 8)
        kind = i % 28
        e, r, s, v, ok = int.from_bytes(digest, "big"), sig.r, sig.s, \
            sig.v, True
        if kind == 8:
            r = 0
        elif kind == 9:
            s = N
        elif kind == 10:
            v = 2
        elif kind == 11:
            r, v = gx, gy_parity
        elif kind == 12:
            e = int.from_bytes(keccak256(b"tampered-%d" % i), "big")
            ok = i % 2 == 0
        elif kind == 13:
            r = ecdsa.P - 1
        elif kind == 14:
            r = (1 << 256) - 1
        elif kind == 15:
            s = (1 << 256) - 1
        elif kind in (16, 17, 18):
            e = (0, N, (1 << 256) - 1)[kind - 16]
        elif kind == 19:
            e, r, s, v = -3 * gx % N, gx, gx, gy_parity
        elif kind in (20, 21):
            e, r, s = -2 * two_g[0] % N, two_g[0], two_g[0]
            v = (two_g[1] & 1) ^ (kind == 21)
        elif kind == 22:
            e, r, s, v = 5, gx, 5, gy_parity
        elif kind == 23:
            r = N
        elif kind == 24:
            s = 0
        elif kind == 25:
            r = no_root
        elif kind == 26:
            v = 5
        elif kind == 27:
            r, s, v = gx, 7, gy_parity ^ 1
        rows.append((e, r, s, v, ok))
    e, r, s, v, ok = zip(*rows)
    planes = (limb.ints_to_limbs(e), limb.ints_to_limbs(r),
              limb.ints_to_limbs(s), np.asarray(v, np.int32),
              np.asarray(ok, bool))
    return [torch.as_tensor(a, device=device) for a in planes]


@functools.lru_cache(maxsize=None)
def _recovery_plain(n: int):
    """`ecrecover_plain` on the card over `_recovery_planes(n)` (one call
    of the plain ladder serves every prefix: rows are independent)."""
    planes = _recovery_planes(n, torch.device("cuda"))
    with route.plain_versions():
        return tuple(secp.ecrecover_batch(*planes))


def _sample_rows(n: int):
    """n sample rows: 16 real samples of one depth-8 tree in turn, every
    fifth row with a flipped chunk byte and every seventh with a wrong
    root; (chunks, indices, proofs, roots)."""
    rng = np.random.default_rng(17)
    data = rng.integers(0, 256, (16, 4096), dtype=np.uint8)
    chunks = [data[k].tobytes() for k in range(16)]
    leaves = [rng.bytes(32) for _ in range(255)]
    for k in range(16):
        leaves[k * 15] = das.chunk_leaf(chunks[k])
    levels = das.merkle_levels(leaves)
    root = levels[-1][0]
    rows = []
    for i in range(n):
        k = i % 16
        chunk = chunks[k]
        if i % 5 == 4:
            chunk = bytes([chunk[0] ^ 1]) + chunk[1:]
        rows.append((chunk, k * 15, das.merkle_proof(levels, k * 15),
                     b"\x01" * 32 if i % 7 == 6 else root))
    return tuple(map(list, zip(*rows)))


def _sample_planes(n: int, device):
    """`_sample_rows(n)` as the `marshal_samples` planes on `device`."""
    st = das.marshal_samples(*_sample_rows(n), n)
    return [torch.as_tensor(st[k], device=device) for k in das.PLANES]


def test_vote_kernel_wrappers_refuse_cpu_tensors():
    before = _build.launch_counts()
    planes = _recovery_planes(3, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        secp.ecrecover_kernel(*planes)
    with pytest.raises(ValueError, match="CUDA"):
        das.verify_planes_kernel(*_sample_planes(2, "cpu"))
    assert _build.launch_counts() == before


@pytest.mark.cuda
def test_vote_kernels_refuse_wrong_shapes_and_types(cuda):
    before = _build.launch_counts()
    e, r, s, v, ok = _recovery_planes(3, cuda)
    with pytest.raises(ValueError, match="shape"):
        secp.ecrecover_kernel(e, r[:, :-1].contiguous(), s, v, ok)
    with pytest.raises(ValueError, match="bool"):
        secp.ecrecover_kernel(e, r, s, v, ok.to(torch.int32))
    planes = _sample_planes(2, cuda)
    short = planes[0][:, :-1].contiguous()
    with pytest.raises(ValueError, match="shape"):
        das.verify_planes_kernel(short, *planes[1:])
    with pytest.raises(ValueError, match="uint8"):
        das.verify_planes_kernel(planes[0].to(torch.int32), *planes[1:])
    assert _build.launch_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 7, 17, 112, 113])
def test_ecrecover_kernel_equals_plain_at_rows(cuda, n):
    """Row counts that leave a warp (4 rows) or a block (8 rows) part
    full: one row, one less than a warp, one less than a block, two blocks
    and one, and the notary's 112 and 113. qx, qy and ok equal to the
    plain version on the card, in one launch, at 25 limbs and at the
    exact form's 22 (every value is below 2^256)."""
    planes = _recovery_planes(n, cuda)
    want = [w[:n] for w in _recovery_plain(113)]
    before = secp.KERNEL.launches
    got = secp.ecrecover_batch(*planes)
    assert secp.KERNEL.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[2][0]
    if n > 8:   # rows 0-7 are valid signatures
        assert not got[2].all()
    nl = 22
    qx, qy = (torch.empty((n, nl), dtype=torch.int32, device=cuda)
              for _ in range(2))
    ok = torch.empty(n, dtype=torch.bool, device=cuda)
    short = [planes[k][:, :nl].contiguous() for k in range(3)]
    secp.KERNEL.launch(*map(_build.ptr, short + planes[3:]), n, nl,
                       *map(_build.ptr, (qx, qy, ok)))
    assert torch.equal(qx, want[0][:, :nl]) and torch.equal(qy, want[1][:, :nl])
    assert torch.equal(ok, want[2])


@pytest.mark.cuda
def test_ecrecover_is_one_launch_per_call(cuda):
    """`ecrecover_batch` launches `gs_ecrecover` once per call, whatever
    the leading dims or row count; the rows of a (2, 3) batch are those
    of its flat 6."""
    planes = _recovery_planes(23, cuda)
    for n in (1, 9, 23):
        before = secp.KERNEL.launches
        secp.ecrecover_batch(*(t[:n] for t in planes))
        assert secp.KERNEL.launches == before + 1
    flat = secp.ecrecover_batch(*(t[:6] for t in planes))
    before = secp.KERNEL.launches
    lead = secp.ecrecover_batch(*(t[:6].reshape((2, 3) + t.shape[1:])
                                  for t in planes))
    assert secp.KERNEL.launches == before + 1
    for g, w in zip(lead, flat):
        assert torch.equal(g.reshape(w.shape), w)


_DAS_S = torch_das_rows.block_samples()


@pytest.mark.cuda
@pytest.mark.parametrize("n", sorted({1, _DAS_S - 1, _DAS_S, _DAS_S + 1, 15,
                                      16, 113, 1792}))
def test_das_kernel_equals_plain_at_rows(cuda, n):
    """Row counts that leave a block of DAS_BLOCK_SAMPLES rows part full,
    113 and the bucket of a 100-shard period (1,792): verdicts equal to
    the plain version on the card, one launch a call, on samples of one
    depth-8 tree, on rows of mixed depths (0, 2, 3 and 8 in each block)
    with hostile and host-rejected rows, and on those rows with the
    valid flag cleared for a whole block."""
    mixed = das.marshal_samples(*torch_das_rows.mixed_rows(n), n)
    dark = mixed["valid"].copy()
    dark[_DAS_S:2 * _DAS_S] = False
    for planes in (_sample_planes(n, cuda),
                   [torch.as_tensor(mixed[k], device=cuda)
                    for k in das.PLANES],
                   [torch.as_tensor(mixed[k] if k != "valid" else dark,
                                    device=cuda) for k in das.PLANES]):
        before = das.KERNEL.launches
        got = das.verify_planes(*planes)
        assert das.KERNEL.launches == before + 1
        with route.plain_versions():
            want = das.verify_planes(*planes)
        assert torch.equal(got, want)
    assert got[:_DAS_S].tolist() == das.verify_samples(
        *(col[:_DAS_S] for col in torch_das_rows.mixed_rows(n)))
    if n > 1:
        assert want.any() and not want.all()
    if n > _DAS_S:
        assert not got[_DAS_S:2 * _DAS_S].any()


@pytest.mark.cuda
def test_vote_phase_on_card(cuda):
    """`ecrecover_addresses` and `das_verify_samples` through the
    backend: one launch of each kernel and no other, the host's scalar
    answers."""
    digests, sigs65, want = [], [], []
    for i in range(6):
        _, digest, sig = _signed(i)
        wire = sig.to_bytes65()
        digests.append(digest)
        sigs65.append(wire if i != 5 else wire[:64])
        want.append(ecdsa.ecrecover_address(digest, sig) if i != 5 else None)
    rows = _sample_rows(20)
    backend = TorchSigBackend()
    for k in _build.KERNELS.values():
        k.launches = 0
    assert backend.ecrecover_addresses(digests, sigs65) == want
    assert backend.das_verify_samples(*rows) == das.verify_samples(*rows)
    counts = {n: c for n, c in _build.launch_counts().items() if c}
    assert counts == {"ecrecover": 1, "das_samples": 1}
    assert backend.last_wire["rows"] == 20


# == the replay's kernels: keccak_fixed and replay ============================


def _launches_from_zero():
    for k in _build.KERNELS.values():
        k.launches = 0


def _launched():
    return {name: c for name, c in _build.launch_counts().items() if c}


@pytest.mark.cuda
@pytest.mark.parametrize("length,n", [(0, 3), (1, 5), (64, 300), (96, 129),
                                      (135, 7), (136, 7), (137, 2),
                                      (245_760, 1), (271, 3), (272, 1),
                                      (2_720, 1), (2_720, 3), (245_760, 3),
                                      (180, 1024)])
def test_keccak_fixed_kernel_equals_plain(cuda, length, n):
    """One launch a call, at the block edges, the warp route's threshold
    (135 bytes: the thread route; 136 and 137: the warp route), the
    root's length, 1 and 3 long rows, the stress step's roots."""
    from gethsharding_tpu_torch.ops import keccak

    data = torch.as_tensor(np.random.default_rng(length).integers(
        0, 256, (n, length), dtype=np.uint8), device=cuda)
    _launches_from_zero()
    got = keccak.keccak256(data)
    assert _launched() == ({"keccak_fixed": 1} if n else {})
    want = keccak.keccak256_fixed(data)
    assert torch.equal(got, want)
    assert [bytes(d) for d in got.cpu().numpy()[:2]] == \
        [keccak256(bytes(m)) for m in data.cpu().numpy()[:2]]


@pytest.mark.cuda
def test_keccak_fixed_kernel_on_unaligned_rows_and_leading_dims(cuda):
    """Rows off 8-byte boundaries, of 67 bytes (the thread route) and 300
    (the warp route)."""
    from gethsharding_tpu_torch.ops import keccak

    for length in (67, 300):
        buf = torch.as_tensor(np.random.default_rng(8).integers(
            0, 256, 1 + 6 * length, dtype=np.uint8), device=cuda)
        rows = buf[1:].reshape(2, 3, length)
        got = keccak.keccak256(rows)
        assert got.shape == (2, 3, 32)
        want = keccak.keccak256_fixed(rows)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="expected .N, L."):
        keccak.keccak_fixed_kernel(rows)


def _replay_planes(planes, device):
    return [torch.as_tensor(p, device=device) for p in planes]


@pytest.mark.cuda
@pytest.mark.parametrize("seed,S,T,A", [(1, 4, 9, 6), (2, 3, 40, 3),
                                        (3, 2, 5, 300), (4, 1, 0, 4),
                                        (5, 1, 64, 4096), (6, 1024, 1, 3)])
def test_replay_kernel_equals_plain(cuda, seed, S, T, A):
    import torch_replay_rows

    _check_replay(torch_replay_rows.seeded_planes(seed, S, T, A), cuda)


def _check_replay(planes, device):
    """One launch of the replay kernel, equal to the plain version on
    the card."""
    from gethsharding_tpu_torch.ops import replay

    planes = [p if isinstance(p, torch.Tensor) else
              torch.as_tensor(p, device=device) for p in planes]
    with route.plain_versions():
        want = replay.shard_replay(*planes)
    _launches_from_zero()
    got = replay.shard_replay(*planes)
    assert _launched() == {"replay": 1}
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,S,T,A,G", [
    (1, 1, 9, 600, 3), (3, 2, 5, 300, 2), (4, 1, 0, 600, 3),
    (5, 1, 300, 1000, 4), (7, 1, 64, 1000, 4), (8, 2, 129, 700, 3),
    (6, 140, 3, 5, 1), (9, 1, 64, 4096, 16), (10, 133, 64, 4096, 1)])
def test_replay_kernel_split_and_tiles(cuda, seed, S, T, A, G):
    """A shard's table over the launcher's G blocks (every table of more
    than 256 rows, at few shards), transactions over several tiles (64 a
    tile), more shards than SMs, one block over 16 scan chunks."""
    import torch_replay_rows
    from gethsharding_tpu_torch.ops import replay

    assert replay.split_blocks(S, A) == G
    _check_replay(torch_replay_rows.seeded_planes(seed, S, T, A), cuda)


@pytest.mark.cuda
def test_replay_kernel_unaligned_tables(cuda):
    """A balance table off a 16-byte boundary: the copy's 4-byte path."""
    import torch_replay_rows

    planes = torch_replay_rows.seeded_planes(1, 4, 9, 6)
    buf = np.zeros(planes[2].size + 1, np.int32)
    buf[1:] = planes[2].ravel()
    planes = _replay_planes(planes, cuda)
    planes[2] = torch.as_tensor(buf, device=cuda)[1:].view(4, 6, 32)
    assert planes[2].data_ptr() % 16
    _check_replay(planes, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["one row", "two rows"])
def test_replay_kernel_same_rows(cuda, kind):
    import torch_replay_rows

    _check_replay(torch_replay_rows.same_row_planes(kind), cuda)


@pytest.mark.cuda
def test_replay_batch_on_the_card(cuda):
    """The hostile batch end to end: one launch each of the recovery and
    the replay, two of the keccak, and the plain versions' outputs (the
    plain recovery takes seconds on the card)."""
    import torch_replay_rows
    from gethsharding_tpu_torch.core import state_processor as sp
    from gethsharding_tpu_torch.core.types import Transaction
    from gethsharding_tpu_torch.ops import replay
    from gethsharding_tpu_torch.utils.hexbytes import Address20

    batch = torch_replay_rows.batch(sp, Transaction, ecdsa, Address20)
    inp = replay.build_replay_inputs(*batch, device=cuda)
    _launches_from_zero()
    out = replay.replay_batch(inp)
    assert _launched() == {"ecrecover": 1, "keccak_fixed": 2, "replay": 1}
    with route.plain_versions():
        want = replay.replay_batch(inp)
    for name in replay.ReplayOutputs._fields:
        assert torch.equal(getattr(out, name), getattr(want, name)), name
    statuses = [s + [False] * (out.statuses.shape[1] - len(s))
                for s in torch_replay_rows.STATUSES]
    assert out.statuses.tolist() == statuses


@pytest.mark.cuda
def test_replay_kernel_refuses_unaligned_addresses(cuda):
    import torch_replay_rows
    from gethsharding_tpu_torch.ops import replay

    planes = _replay_planes(torch_replay_rows.seeded_planes(7, 2, 3, 5),
                            cuda)
    buf = torch.zeros(2 * 5 * 20 + 1, dtype=torch.uint8, device=cuda)
    planes[0] = buf[1:].view(2, 5, 20)
    with pytest.raises(ValueError, match="4-byte aligned"):
        replay.shard_replay_kernel(*planes)


@pytest.mark.cuda
def test_stress_step_on_the_card(cuda):
    from gethsharding_tpu_torch.parallel import stress
    from gethsharding_tpu_torch.params import Config

    inputs, pool, bh, size, _ = stress.build_stress_inputs(
        5, votes_per_shard=3, txs_per_shard=2, committee_size=7,
        device=cuda)
    pipe = stress.StressPipeline(Config(committee_size=7, quorum_size=2))
    _launches_from_zero()
    out = pipe.run(inputs, pool, bh, 1, size)
    launched = _launched()
    assert {k: v for k, v in launched.items() if k != "norm"} == {
        "keccak_fixed": 3, "agg_g1": 1, "agg_g2": 1, "miller": 1,
        "finalexp": 1, "ecrecover": 1, "replay": 1}
    with route.plain_versions():
        want = pipe.run(inputs, pool, bh, 1, size)
    for name in stress.StressOutputs._fields:
        assert torch.equal(getattr(out, name), getattr(want, name)), name
    assert bool(out.accepted.all() & out.agg_ok.all() & out.tx_status.all())
    assert int(out.total_votes) == 15 and int(out.total_elected) == 5


@pytest.mark.cuda
def test_notary_on_the_card(cuda):
    """The port's notary over the small scripted chain of
    `tests/torch_notary_script.py` on the card, launches counted around
    each head: period 1's head recovers the signed candidates (one
    `ecrecover`), period 2's audits period 1 (one committee sum of the
    signatures, one final exponentiation, no Miller product: the precomp
    path) and replays its vote log (one `keccak_fixed`). Audit results,
    counters, vote words and the replay's answers equal the same script's
    on device="cpu"."""
    import torch_notary_script as script

    m = script.modules("gethsharding_tpu_torch")
    card = script.run(m, TorchSigBackend(), {}, counts=_build.launch_counts)
    cpu = script.run(m, TorchSigBackend(device="cpu"), {"device": "cpu"})
    got, want = card["summary"], cpu["summary"]
    for key in ("heads", "audit_periods", "replay", "head_counters",
                "counters", "errors", "words", "shard_db"):
        assert got[key] == want[key], key
    assert got["heads"] == script.HEAD_AUDITS
    assert got["replay"] == script.REPLAY
    launches = got["head_launches"]
    assert launches[1] == {"ecrecover": 1}
    audit = launches[2]
    assert (audit["agg_g1"], audit["finalexp"], audit["keccak_fixed"]) \
        == (1, 1, 1)
    assert "miller" not in audit and "ecrecover" not in audit
    assert set(audit) <= {"agg_g1", "agg_g2", "tower", "norm", "finalexp",
                          "keccak_fixed"}


@pytest.mark.cuda
def test_library_first_use_builds_once(cuda, monkeypatch):
    """Eight threads asking for the kernel library at once (a node's
    services on their first launch) build and load it once, and all get
    the same library."""
    import threading
    import time

    _build.library()                       # built and loaded
    calls = []
    real_build = _build.build

    def slow_build():
        calls.append(threading.get_ident())
        time.sleep(0.2)                    # widen the window
        return real_build()

    monkeypatch.setattr(_build, "build", slow_build)
    monkeypatch.setattr(_build, "_lib", None)
    got, start = [], threading.Barrier(8)

    def first_use():
        start.wait()
        got.append(_build.library())

    threads = [threading.Thread(target=first_use) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(calls) == 1
    assert len(got) == 8 and all(lib is got[0] for lib in got)


@pytest.mark.cuda
def test_node_devnet_on_the_card(cuda):
    """The port's sharding node over `tests/torch_node_script.py`'s small
    devnet (4 shards, a pool of 8, quorum 1, windback 1) on the card:
    every node's shard DB, the votes, the notary's journal and mirror
    snapshot and the observer's roots equal the same devnet's on
    device="cpu" after every period; each auditing head launches the
    audit's kernels and each replaying block the replay's."""
    import torch_node_script as script

    m = script.modules("gethsharding_tpu_torch")
    cfg = script.cpu_config(m)
    card = script.run(m, cfg, script.CPU_POOL, 3, {"sig_backend": "torch"},
                      counts=_build.launch_counts)
    cpu = script.run(m, cfg, script.CPU_POOL, 3,
                     {"sig_backend": "torch", "device": "cpu"})
    assert script.jsonable(card["summaries"]) == script.jsonable(
        cpu["summaries"])
    plen = cfg.period_length
    launches = card["launches"]
    for period in (2, 3):
        head = launches[period][period * plen]
        assert (head["agg_g1"], head["finalexp"]) == (1, 1), head
        assert head["keccak_fixed"] >= 1 and head["tower"] and head["norm"]
        assert head["ecrecover"] == 1, head
    for period in (1, 2, 3):
        replay = launches[period][period * plen + 1]
        assert replay["replay"] == 1 and replay["ecrecover"] >= 1, replay
        assert replay["keccak_fixed"] >= 2, replay
    errors = card["summaries"][4]["errors"]
    assert all(not e for e in errors.values()), errors


# the hostile kinds the small devnet's layout has room for, by scheme
_SAMPLED_HOSTILE = {"merkle": ("withhold", "garbage"),
                    "poly": ("withhold", "merkle_only")}


@pytest.mark.cuda
@pytest.mark.parametrize("proofs", ["merkle", "poly"])
def test_node_sampled_devnet_on_the_card(cuda, proofs):
    """The small devnet with every node sampled (`da_mode="sampled"`), two
    hostile shards on the notary's path, on the card: the summaries (the
    notary's votes, verdict cache, das counters and errors, every shard
    DB) equal the same devnet's on device="cpu", whose batched calls run
    the plain versions; each block's head launches the batched DAS
    kernels the layout gives, one `das_samples` (merkle) or one `miller`
    and one `finalexp` (poly) a call, beside the audit's `finalexp`."""
    import torch_node_script as script

    m = script.modules("gethsharding_tpu_torch")
    cfg = script.cpu_config(m)
    kw = dict(da_proofs=proofs, hostile=_SAMPLED_HOSTILE[proofs])
    card = script.run(m, cfg, script.CPU_POOL, 2, {"sig_backend": "torch"},
                      counts=_build.launch_counts, **kw)
    cpu = script.run(m, cfg, script.CPU_POOL, 2,
                     {"sig_backend": "torch", "device": "cpu"}, **kw)
    assert script.jsonable(card["summaries"]) == script.jsonable(
        cpu["summaries"])
    plen = cfg.period_length
    want = script.sampled_expected(card["layout"], plen, 2)
    assert want["honest"] and want["hostile"]
    launches = {}
    for blocks in card["launches"].values():
        launches.update(blocks)
    audits = {p * plen for p in (2, 3)}
    kernels = ("das_samples",) if proofs == "merkle" else ("miller",
                                                           "finalexp")
    for block in sorted(set(launches) | set(want["calls"])):
        got = launches.get(block, {})
        for k in kernels:
            extra = int(k == "finalexp" and block in audits)
            assert got.get(k, 0) == want["calls"].get(block, 0) + extra, \
                (block, got)
    last = card["summaries"][3]
    assert last["notary"]["votes_submitted"] == len(want["honest"])
    assert last["das"]["notary_body_requests"] == 0
    assert [tuple(v) for v in last["das"]["verdicts"]] == want["held"]


# == the serving tier over the card's backend =================================


def _vote_rows(n: int):
    """n recovery rows: signatures of `_signed`, every fourth truncated."""
    digests, sigs65 = [], []
    for i in range(n):
        _, digest, sig = _signed(i % 12)
        wire = sig.to_bytes65()
        digests.append(digest)
        sigs65.append(wire[:64] if i % 4 == 3 else wire)
    return digests, sigs65


@pytest.mark.cuda
def test_serving_on_card_equals_direct(cuda):
    """Concurrent threads' committee (keyed and keyless), recovery and
    sample requests through `ServingSigBackend(TorchSigBackend())`: every
    request's result is the direct call's on its rows, in fewer
    dispatches than requests, on the dispatch thread's kernels."""
    import threading

    from gethsharding_tpu_torch.serving import ServingSigBackend

    msgs, sig_rows, pk_rows, want_c = _committee_period(24, 6)
    keys = [("cuda-serving", s) for s in range(24)]
    digests, sigs65 = _vote_rows(32)
    samples = _sample_rows(48)
    direct = TorchSigBackend()
    want_r = direct.ecrecover_addresses(digests, sigs65)
    want_s = direct.das_verify_samples(*samples)
    assert direct.bls_verify_committees(msgs, sig_rows, pk_rows,
                                        pk_row_keys=keys) == want_c
    jobs = [("bls_verify_committees", (msgs[i:i + 3], sig_rows[i:i + 3],
                                       pk_rows[i:i + 3]),
             {"pk_row_keys": keys[i:i + 3]} if i % 2 else {},
             want_c[i:i + 3]) for i in range(0, 24, 3)]
    jobs += [("ecrecover_addresses", (digests[i:i + 1], sigs65[i:i + 1]),
              {}, want_r[i:i + 1]) for i in range(32)]
    jobs += [("das_verify_samples", tuple(c[i:i + 6] for c in samples), {},
              want_s[i:i + 6]) for i in range(0, 48, 6)]
    serving = ServingSigBackend(TorchSigBackend())
    got = [None] * len(jobs)
    barrier = threading.Barrier(len(jobs))

    def run(i):
        op, cols, kw, _ = jobs[i]
        barrier.wait()
        got[i] = serving.submit(op, *cols, **kw).result(timeout=300)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(jobs))]
    try:
        for k in _build.KERNELS.values():
            k.launches = 0
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not any(t.is_alive() for t in threads)
        counts = dict(serving.batcher.dispatch_counts)
    finally:
        serving.close()
    assert got == [want for _, _, _, want in jobs]
    assert sum(counts.values()) < len(jobs)
    launched = _build.launch_counts()
    assert launched["ecrecover"] == counts["ecrecover_addresses"]
    assert launched["das_samples"] == counts["das_verify_samples"]
    assert launched["finalexp"] == counts["bls_verify_committees"]


@pytest.mark.cuda
def test_two_threads_in_one_backend_equal_each_alone(cuda):
    """Two threads calling one `TorchSigBackend` at once (the watchdog's
    stale and fresh dispatch threads): each gets the verdicts it gets
    alone, on every op it calls."""
    import threading

    backend = TorchSigBackend()
    msgs, sig_rows, pk_rows, want_c = _committee_period(16, 5)
    keys = [("cuda-two", s) for s in range(16)]
    digests, sigs65 = _vote_rows(24)
    samples = _sample_rows(64)
    alone = {
        "committees": backend.bls_verify_committees(msgs, sig_rows, pk_rows,
                                                    pk_row_keys=keys),
        "recover": backend.ecrecover_addresses(digests, sigs65),
        "samples": backend.das_verify_samples(*samples),
    }
    assert alone["committees"] == want_c
    calls = {
        "committees": lambda: backend.bls_verify_committees_async(
            msgs, sig_rows, pk_rows, pk_row_keys=keys).result(),
        "recover": lambda: backend.ecrecover_addresses(digests, sigs65),
        "samples": lambda: backend.das_verify_samples(*samples),
    }
    out = {"a": [], "b": []}

    def worker(name, order):
        for _ in range(4):
            for op in order:
                out[name].append((op, calls[op]()))

    threads = [threading.Thread(target=worker, args=(
        "a", ("committees", "samples", "recover"))),
               threading.Thread(target=worker, args=(
        "b", ("samples", "recover", "committees")))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    for name in out:
        assert len(out[name]) == 12
        for op, res in out[name]:
            assert res == alone[op], (name, op)


@pytest.mark.cuda
def test_dispatch_thread_launches_on_the_default_stream(cuda):
    """The serving dispatch thread launches on PyTorch's default stream
    (no serving thread sets another): the recovery launched there is
    counted, and the stream it saw is the default one."""
    from gethsharding_tpu_torch.serving import ServingSigBackend

    seen = []

    class Watched(TorchSigBackend):
        def ecrecover_addresses(self, digests, sigs65):
            seen.append((torch.cuda.current_stream(),
                         torch.cuda.default_stream()))
            return super().ecrecover_addresses(digests, sigs65)

    digests, sigs65 = _vote_rows(4)
    serving = ServingSigBackend(Watched())
    try:
        for k in _build.KERNELS.values():
            k.launches = 0
        got = serving.ecrecover_addresses(digests, sigs65)
    finally:
        serving.close()
    assert got == TorchSigBackend().ecrecover_addresses(digests, sigs65)
    assert len(seen) == 1 and seen[0][0] == seen[0][1]
    assert _build.launch_counts()["ecrecover"] >= 1


@pytest.mark.cuda
def test_rpc_committees_on_card_equal_plain(cuda):
    """A committee batch over the wire: an in-process `RPCServer` holding
    `TorchSigBackend()` serves `shard_verifyCommittees` (keyed rows, a
    forged vote and an empty committee) and `shard_verifyPeriodBatch`
    from the serving tier's dispatch thread; the verdicts equal the
    plain versions' on the same planes, with one `agg_g1` and one
    `finalexp` launch for the call."""
    from gethsharding_tpu_torch.rpc import codec
    from gethsharding_tpu_torch.rpc.client import RPCClient
    from gethsharding_tpu_torch.rpc.server import RPCServer
    from gethsharding_tpu_torch.smc.chain import SimulatedMainchain

    msgs, sig_rows, pk_rows, want = _committee_period(8, 5)
    keys = [("cuda-rpc", s) for s in range(len(msgs))]
    server = RPCServer(SimulatedMainchain(), port=0,
                       sig_backend=TorchSigBackend())
    server.start()
    client = RPCClient(*server.address, timeout=600)
    try:
        args = ([codec.enc_bytes(m) for m in msgs],
                codec.enc_g1_rows(sig_rows), codec.enc_g2_rows(pk_rows),
                codec.enc_pk_row_keys(keys))
        assert client.call("shard_verifyCommittees", *args) == want
        for k in _build.KERNELS.values():
            k.launches = 0
        assert client.call("shard_verifyCommittees", *args) == want
        launched = _build.launch_counts()
        assert launched["agg_g1"] == 1 and launched["finalexp"] == 1
        stats = client.call("shard_servingStats")
        assert stats["dispatches"]["bls_verify_committees"] == 2
        assert client.call("shard_verifyPeriodBatch", 0) is None
    finally:
        client.close()
        server.stop()
    planes = [torch.as_tensor(a, device=cuda)
              for a in committee_planes(msgs, sig_rows, pk_rows)]
    with route.plain_versions():
        plain = bn.bls_aggregate_verify_committee_batch(*planes)
    assert plain.cpu()[:len(msgs)].tolist() == want


# == the shard mesh over repeated slots of the card ===========================

MESH_SLOTS = 4


@pytest.mark.cuda
def test_mesh_audit_on_repeated_card_equals_one_device(cuda):
    """`TorchSigBackend` over 4 slots of the card: keyed cold and warm and
    unkeyed audits equal one device's; one reduction a step; each slot
    launched its audit kernels; the slots' caches share no tensor."""
    msgs, sig_rows, pk_rows, want = _committee_period(9, 5)
    keys = [("mesh", s) for s in range(9)]
    slots = [torch.device("cuda", 0)] * MESH_SLOTS
    single = TorchSigBackend(device=slots[0])
    meshed = TorchSigBackend(device=slots)
    for row_keys in (keys, keys, None):
        assert single.bls_verify_committees(msgs, sig_rows, pk_rows,
                                            pk_row_keys=row_keys) == want
        before = meshed.layout.mesh.reductions
        assert meshed.bls_verify_committees(msgs, sig_rows, pk_rows,
                                            pk_row_keys=row_keys) == want
        info = meshed.last_mesh
        assert meshed.layout.mesh.reductions - before == 1
        assert info["collectives"] == 1
        assert info["verdict_devices"] == MESH_SLOTS
        assert info["vote_total"] == sum(want)
        for launched in info["slot_launches"]:
            assert launched["agg_g1"] == 1 and launched["finalexp"] == 1
    ptrs = [{t.untyped_storage().data_ptr() for t in c.tensors()}
            for c in meshed.line_shards]
    for i in range(MESH_SLOTS):
        for j in range(i + 1, MESH_SLOTS):
            assert not ptrs[i] & ptrs[j]


@pytest.mark.cuda
def test_mesh_pipelines_on_repeated_card_equal_one_device(cuda):
    """The committee period pipeline (1-D and 2 × 2) and the stress step
    over 4 slots of the card, an uneven shard count, equal to one device
    bit for bit."""
    from gethsharding_tpu_torch.parallel import mesh, period, stress
    from gethsharding_tpu_torch.params import Config

    slots = [torch.device("cuda", 0)] * MESH_SLOTS
    msgs, sig_rows, pk_rows, want = _committee_period(9, 5)
    cfg = Config(committee_size=5, quorum_size=3)
    one = period.CommitteePeriodPipeline(cfg, device=cuda)
    inputs = one.build_inputs(msgs, sig_rows, pk_rows)
    base = one.run(inputs)
    assert base.verified.tolist() == want
    for m in (mesh.make_mesh(devices=slots),
              mesh.make_multihost_mesh(2, 2, slots)):
        out = period.CommitteePeriodPipeline(cfg, mesh=m).run(inputs)
        for name in period.PeriodOutputs._fields:
            assert torch.equal(getattr(out, name), getattr(base, name)), name
    s_in, pool, bh, size, _ = stress.build_stress_inputs(
        5, votes_per_shard=3, txs_per_shard=2, committee_size=7,
        device=cuda)
    scfg = Config(committee_size=7, quorum_size=2)
    want_s = stress.StressPipeline(scfg).run(s_in, pool, bh, 1, size)
    _launches_from_zero()
    got_s = stress.StressPipeline(scfg, mesh=mesh.make_mesh(
        devices=slots)).run(s_in, pool, bh, 1, size)
    launched = _launched()
    assert launched["finalexp"] == launched["replay"] == MESH_SLOTS
    for name in stress.StressOutputs._fields:
        assert torch.equal(getattr(got_s, name), getattr(want_s, name)), name


@pytest.mark.cuda
def test_mesh_launch_failure_is_loud(cuda, monkeypatch):
    """A kernel launch failing on one slot fails the whole mesh audit: no
    slot's verdicts stand in for it, and nothing falls back."""
    msgs, sig_rows, pk_rows, _ = _committee_period(9, 5)
    meshed = TorchSigBackend(device=[torch.device("cuda", 0)] * MESH_SLOTS)
    kernel = _build.KERNELS["finalexp"]
    real = kernel.launch
    calls = []

    def launch(*args):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("finalexp: kernel launch failed (injected)")
        return real(*args)

    monkeypatch.setattr(kernel, "launch", launch)
    with pytest.raises(RuntimeError, match="injected"):
        meshed.bls_verify_committees(msgs, sig_rows, pk_rows)
    assert len(calls) == 3
