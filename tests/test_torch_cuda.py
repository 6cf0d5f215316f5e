"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Imports nothing of JAX, so the same file runs on a machine with an
NVIDIA card and no JAX:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider

Where there is no card the `cuda` tests skip with a reason; the wrapper
checks below run everywhere. Workloads are protocol-true committees made
with the port's own scalar crypto from fixed seeds."""

import numpy as np
import pytest
import torch

from gethsharding_tpu_torch.crypto import bn256 as bls
from gethsharding_tpu_torch.ops import bn256 as bn
from gethsharding_tpu_torch.ops import megakernels as mk
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


@pytest.mark.cuda
@pytest.mark.parametrize("fp2", [False, True])
def test_agg_kernel_equals_plain(cuda, fp2):
    rng = np.random.default_rng(91)
    n, cdim = 67, 37     # an odd batch, a committee far from a power of 2
    point = (2,) if fp2 else ()
    xs = _canon(rng, (n, cdim) + point, cuda)
    ys = _canon(rng, (n, cdim) + point, cuda)
    mask = torch.as_tensor(rng.integers(0, 2, (n, cdim)), device=cuda)
    got = mk.agg_kernel(xs, ys, mask.to(torch.int32), fp2=fp2)
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
    plain = bn.bls_aggregate_verify_committee_batch(*planes, plain=True)
    assert plain.cpu()[:len(msgs)].tolist() == want
