"""The CUDA kernels against their plain PyTorch versions, on the card.

Every case needs a CUDA device and ``nvcc`` (the kernels are CUDA C++ for
``sm_90a`` and have no interpret mode); without a card each skips with the
reason.  This file imports no JAX, so it runs on a GPU machine as it is:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
"""
import pytest
import torch

from repro_torch.kernels import ops, ref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ for "
                    "sm_90a and have no interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("C,P,K", [(800, 30720, 4), (800, 150, 4),
                                   (32, 6, 4), (16, 3000, 5), (5, 17, 16)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_weighted_agg_multi_kernel_matches_plain(cuda_device, C, P, K, dt):
    g = torch.Generator(device=cuda_device).manual_seed(C + P + K)
    s = torch.randn((C, P), generator=g, device=cuda_device).to(dt)
    w = torch.rand((C, K), generator=g, device=cuda_device)
    before = ops.LAUNCHES["weighted_agg_multi"]
    got = ops.weighted_agg_multi(s, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["weighted_agg_multi"] == before + 1
    want = ref.weighted_agg_multi_ref(s, w)
    # the reference sweep's 2e-5 held for C <= 16; with unnormalized weights
    # an output sums C terms of size ~1, so the two summation orders drift
    # apart in proportion to C (chip_smoke.py holds the engine's normalized
    # weights at C = 800 to 2e-5)
    tol = 2e-5 * max(1.0, C / 16) if dt == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,K", [(800, 3, 4), (10000, 3, 4), (1000, 10, 7),
                                   (64, 128, 16)])
def test_kmeans_assign_kernel_matches_plain(cuda_device, N, D, K):
    g = torch.Generator(device=cuda_device).manual_seed(N + D + K)
    x = torch.randn((N, D), generator=g, device=cuda_device)
    c = torch.randn((K, D), generator=g, device=cuda_device)
    a, d = ops.kmeans_assign(x, c)
    torch.cuda.synchronize()
    ar, dr = ref.kmeans_assign_ref(x, c)
    torch.testing.assert_close(d, dr, rtol=1e-4, atol=1e-4)
    # exact wherever the two best distances differ by more than rounding
    dist = ((x * x).sum(-1)[:, None] - 2.0 * x @ c.T + (c * c).sum(-1))
    two = dist.topk(2, dim=1, largest=False).values
    clear = (two[:, 1] - two[:, 0]) > 1e-5 * two[:, 1].abs().clamp_min(1.0)
    assert torch.equal(a[clear], ar[clear])
