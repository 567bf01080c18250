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


# LeNet's leaves, per client: c1.w c1.b c2.w c2.b f1.w f1.b f2.w f2.b f3.w f3.b
LENET_P = [150, 6, 2400, 16, 30720, 120, 10080, 84, 840, 10]


def _tree(ps, c, k, dt, device, seed):
    """(C, P) leaves and (C, K) weights normalized per cluster, as the
    engine's stage-1 weights are (so outputs are weighted averages)."""
    g = torch.Generator(device=device).manual_seed(seed)
    leaves = tuple(torch.randn((c, p), generator=g, device=device).to(dt)
                   for p in ps)
    w = torch.rand((c, k), generator=g, device=device)
    return leaves, (w / w.sum(0, keepdim=True)).contiguous()


def _assert_tree_close(got, leaves, w, dt):
    tol = 2e-5 if dt == torch.float32 else 3e-2
    for out, x in zip(got, leaves):
        assert out.shape == (w.shape[1], x.shape[1]) and out.dtype == dt
        torch.testing.assert_close(
            out.float(), ref.weighted_agg_multi_ref(x, w).float(), rtol=tol,
            atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [32, 800])
@pytest.mark.parametrize("K", [1, 4, 16])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_grouped_kernel_matches_plain_on_lenet(cuda_device, C, K, dt):
    """One launch for LeNet's 10 leaves, equal to the plain version leaf by
    leaf, and the same bits from a second call."""
    leaves, w = _tree(LENET_P, C, K, dt, cuda_device, C + K)
    before = ops.LAUNCHES["weighted_agg_multi"]
    got = ops.weighted_agg_multi_tree(leaves, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["weighted_agg_multi"] == before + 1
    _assert_tree_close(got, leaves, w, dt)
    again = ops.weighted_agg_multi_tree(leaves, w)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [32, 800])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_grouped_kernel_takes_unaligned_leaves(cuda_device, C, dt):
    """Unaligned leaves (P = 150, 6, 10: one element a lane), P = 4097
    (P = 1 mod 4), and a leaf that starts 8 bytes past a 16-byte boundary,
    beside aligned ones, in one launch."""
    leaves, w = _tree([150, 6, 10, 4097, 1024], C, 4, dt, cuda_device, C)
    offset = torch.empty((C * 1024 + 8,), dtype=dt, device=cuda_device)
    shifted = offset[8 // offset.element_size():][:C * 1024].view(C, 1024)
    shifted.copy_(leaves[-1])
    leaves = leaves[:-1] + (shifted,)
    from repro_torch.kernels import weighted_agg as wagg
    assert not wagg._aligned(shifted)
    got = ops.weighted_agg_multi_tree(leaves, w)
    torch.cuda.synchronize()
    _assert_tree_close(got, leaves, w, dt)


@pytest.mark.cuda
def test_grouped_kernel_refuses_more_leaves_than_its_table(cuda_device):
    """More leaves than the kernel's table are no longer refused: 65 leaves
    take two launches (64 and 1), both counted, equal to plain."""
    from repro_torch.kernels import weighted_agg as wagg
    leaves, w = _tree([64] * (wagg.MAX_LEAVES + 1), 16, 4, torch.float32,
                      cuda_device, 1)
    before = ops.LAUNCHES["weighted_agg_multi"]
    got = ops.weighted_agg_multi_tree(leaves, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["weighted_agg_multi"] == before + 2
    _assert_tree_close(got, leaves, w, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [17, 32, 40, 64])
@pytest.mark.parametrize("C", [32, 800])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_grouped_kernel_takes_any_k(cuda_device, K, C, dt):
    """K above 16 on LeNet's leaves in passes of 16 clusters: equal to
    plain, one launch a tree, the same bits from a second call."""
    leaves, w = _tree(LENET_P, C, K, dt, cuda_device, C + K)
    before = ops.LAUNCHES["weighted_agg_multi"]
    got = ops.weighted_agg_multi_tree(leaves, w)
    again = ops.weighted_agg_multi_tree(leaves, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["weighted_agg_multi"] == before + 2
    _assert_tree_close(got, leaves, w, dt)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [4, 17, 32])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_grouped_kernel_takes_65_leaves(cuda_device, K, dt):
    """65 leaves of mixed widths and alignments: two launches, equal to
    plain, at K = 4, 17 and 32."""
    from repro_torch.kernels import weighted_agg as wagg
    ps = [40 + 3 * i for i in range(wagg.MAX_LEAVES + 1)]
    leaves, w = _tree(ps, 48, K, dt, cuda_device, K + 65)
    before = ops.LAUNCHES["weighted_agg_multi"]
    got = ops.weighted_agg_multi_tree(leaves, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["weighted_agg_multi"] == before + 2
    _assert_tree_close(got, leaves, w, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 2, 4, 5, 8])
@pytest.mark.parametrize("K", [2, 4, 16, 17])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_grouped_kernel_small_c_matches_plain(cuda_device, C, K, dt):
    """C <= 8 (a thread sums all rows of its columns, tiles of 256 lanes):
    LeNet's leaves (their outputs 16-byte aligned or not, as the buffer
    lays them), an unaligned P = 4097 and a leaf 8 bytes past a 16-byte
    boundary, in one launch; equal to plain, the same bits twice."""
    leaves, w = _tree(LENET_P + [4097, 1024], C, K, dt, cuda_device, C + K)
    offset = torch.empty((C * 1024 + 8,), dtype=dt, device=cuda_device)
    shifted = offset[8 // offset.element_size():][:C * 1024].view(C, 1024)
    shifted.copy_(leaves[-1])
    leaves = leaves[:-1] + (shifted,)
    before = ops.LAUNCHES["weighted_agg_multi"]
    got = ops.weighted_agg_multi_tree(leaves, w)
    again = ops.weighted_agg_multi_tree(leaves, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["weighted_agg_multi"] == before + 2
    _assert_tree_close(got, leaves, w, dt)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_grouped_kernel_replays_in_a_cuda_graph(cuda_device):
    """The descriptor table is a kernel parameter: a captured launch
    replays to the eager call's bits."""
    leaves, w = _tree(LENET_P, 800, 4, torch.float32, cuda_device, 9)
    eager = ops.weighted_agg_multi_tree(leaves, w)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.weighted_agg_multi_tree(leaves, w)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ops.weighted_agg_multi_tree(leaves, w)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(eager, captured))


@pytest.mark.cuda
@pytest.mark.parametrize("N,D,K", [(800, 3, 4), (10000, 3, 4), (1000, 10, 7),
                                   (64, 128, 16), (300, 3, 1), (257, 3, 2),
                                   (100, 3, 8), (50, 3, 9), (500, 4, 8),
                                   (300, 1, 2)])
def test_kmeans_assign_kernel_matches_plain(cuda_device, N, D, K):
    """3-D points with K <= 8 take the fixed-shape kernel, the rest the
    loop kernel."""
    g = torch.Generator(device=cuda_device).manual_seed(N + D + K)
    x = torch.randn((N, D), generator=g, device=cuda_device)
    c = torch.randn((K, D), generator=g, device=cuda_device)
    a, d = ops.kmeans_assign(x, c)
    torch.cuda.synchronize()
    ar, dr = ref.kmeans_assign_ref(x, c)
    torch.testing.assert_close(d, dr, rtol=1e-4, atol=1e-4)
    if K == 1:
        assert (a == 0).all()
        return
    # exact wherever the two best distances differ by more than rounding
    dist = ((x * x).sum(-1)[:, None] - 2.0 * x @ c.T + (c * c).sum(-1))
    two = dist.topk(2, dim=1, largest=False).values
    clear = (two[:, 1] - two[:, 0]) > 1e-5 * two[:, 1].abs().clamp_min(1.0)
    assert torch.equal(a[clear], ar[clear])


@pytest.mark.cuda
@pytest.mark.parametrize("C,P", [(2, 64), (16, 1000), (8, 4096), (5, 17),
                                 (16, 1_000_000)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_weighted_agg_kernel_matches_plain(cuda_device, C, P, dt):
    """The K = 1 case of the weighted_agg_multi kernel, at the reference
    sweep's tolerances."""
    g = torch.Generator(device=cuda_device).manual_seed(C + P)
    s = torch.randn((C, P), generator=g, device=cuda_device).to(dt)
    w = torch.rand((C,), generator=g, device=cuda_device)
    before = ops.LAUNCHES["weighted_agg"]
    got = ops.weighted_agg(s, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["weighted_agg"] == before + 1
    assert got.shape == (P,) and got.dtype == dt
    tol = 1e-5 if dt == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), ref.weighted_agg_ref(s, w).float(),
                               rtol=tol, atol=tol)


FLASH_CASES = [
    # the reference's sweep (tests/test_kernels.py):
    # B, Hq, Hkv, Sq, Sk, D, causal, window, softcap
    (1, 4, 2, 128, 128, 64, True, 0, 0.0),
    (2, 4, 4, 96, 96, 32, True, 0, 50.0),
    (1, 8, 2, 256, 256, 64, True, 64, 0.0),
    (1, 2, 1, 1, 300, 64, True, 0, 0.0),
    (1, 2, 1, 1, 300, 64, True, 128, 0.0),
    (1, 2, 2, 128, 128, 64, False, 0, 0.0),
    (2, 2, 2, 70, 70, 128, True, 0, 0.0),
    # gemma2-2b's heads (8 over 4, D = 256, soft-cap 50): global and local
    # layers at a shortened length, with the window cut to match
    (2, 8, 4, 1500, 1500, 256, True, 0, 50.0),
    (2, 8, 4, 1500, 1500, 256, True, 512, 50.0),
    (1, 8, 4, 1, 1500, 256, True, 512, 50.0),
    (1, 8, 4, 40, 40, 80, True, 0, 0.0),           # h2o-danube's D = 80
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda_device, case, dt):
    b, hq, hkv, sq, sk, d, causal, window, cap = case
    g = torch.Generator(device=cuda_device).manual_seed(sq + sk + d)
    q = torch.randn((b, hq, sq, d), generator=g, device=cuda_device).to(dt)
    k = torch.randn((b, hkv, sk, d), generator=g, device=cuda_device).to(dt)
    v = torch.randn((b, hkv, sk, d), generator=g, device=cuda_device).to(dt)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cap)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert got.shape == q.shape and got.dtype == dt
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=cap)
    tol = 3e-5 if dt == torch.float32 else 4e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_attention_kernel_reads_the_models_layout(cuda_device):
    """(B, S, H, D) activations as transposed views: no copy in, the output
    in q's layout, equal to the kernel on contiguous copies."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q = torch.randn((2, 300, 8, 256), generator=g, device=cuda_device)
    k = torch.randn((2, 300, 4, 256), generator=g, device=cuda_device)
    views = [t.transpose(1, 2) for t in (q, k, k)]
    got = ops.flash_attention(*views, window=100, softcap=50.0)
    assert got.transpose(1, 2).is_contiguous()
    want = ops.flash_attention(*[t.contiguous() for t in views], window=100,
                               softcap=50.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# the bf16 tensor-core route (csrc/flash_attention_sm90.cu) on the reference
# sweep's features: ragged S, Sq = 1 against a cache, non-causal, GQA groups
# 1 / 2 / 4, D 32 / 64 / 128 / 256, a window edge inside a kv tile
# B, Hq, Hkv, Sq, Sk, D, causal, window, softcap
TC_CASES = [
    (2, 4, 4, 70, 70, 64, True, 0, 0.0),           # ragged S, group 1
    (1, 4, 2, 96, 96, 32, True, 0, 50.0),          # group 2, D = 32
    (1, 8, 2, 300, 300, 128, True, 0, 0.0),        # group 4, 300 = 2 q tiles + 44
    (1, 8, 4, 1, 300, 256, True, 0, 50.0),         # Sq = 1 against a cache
    (1, 8, 4, 1, 300, 256, True, 100, 50.0),       # ... and a window
    (1, 2, 2, 130, 130, 64, False, 0, 0.0),        # non-causal
    (2, 8, 4, 300, 300, 256, True, 100, 50.0),     # window edge mid-tile
    (1, 4, 1, 257, 257, 256, True, 37, 0.0),       # window < a tile
    (1, 2, 1, 200, 520, 128, True, 0, 30.0),       # Sq < Sk (cached prefix)
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TC_CASES)
def test_flash_attention_tensor_cores_match_plain(cuda_device, case):
    b, hq, hkv, sq, sk, d, causal, window, cap = case
    g = torch.Generator(device=cuda_device).manual_seed(sq + sk + d + window)
    q, k, v = (torch.randn(s, generator=g, device=cuda_device).bfloat16()
               for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
    before = dict(ops.FLASH_ROUTES)
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cap)
    torch.cuda.synchronize()
    assert ops.FLASH_ROUTES["tensor_cores"] == before["tensor_cores"] + 1
    assert ops.FLASH_ROUTES["cuda_cores"] == before["cuda_cores"]
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=cap)
    torch.testing.assert_close(got.float(), want.float(), rtol=4e-2,
                               atol=4e-2)


@pytest.mark.cuda
def test_flash_attention_tensor_cores_read_transposed_views(cuda_device):
    """(B, S, H, D) activations as transposed views go through TMA's
    strided maps: equal to contiguous copies, and to the plain version."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    q = torch.randn((2, 333, 8, 256), generator=g, device=cuda_device).bfloat16()
    k = torch.randn((2, 333, 4, 256), generator=g, device=cuda_device).bfloat16()
    v = torch.randn((2, 333, 4, 256), generator=g, device=cuda_device).bfloat16()
    views = [t.transpose(1, 2) for t in (q, k, v)]
    got = ops.flash_attention(*views, window=70, softcap=50.0)
    assert got.transpose(1, 2).is_contiguous()
    copies = ops.flash_attention(*[t.contiguous() for t in views], window=70,
                                 softcap=50.0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, copies, rtol=0, atol=0)
    want = ref.flash_attention_ref(*views, window=70, softcap=50.0)
    torch.testing.assert_close(got.float(), want.float(), rtol=4e-2,
                               atol=4e-2)


@pytest.mark.cuda
def test_flash_attention_refuses_a_misaligned_bf16_view(cuda_device):
    """A bf16 view one element past a 16-byte boundary raises ValueError
    with the reason: no launch, and no other kernel takes it."""
    flat = torch.randn(2 * 64 * 64 + 1, device=cuda_device).bfloat16()
    k = flat[1:].view(1, 2, 64, 64)          # 2 bytes past the boundary
    q = torch.randn((1, 4, 64, 64), device=cuda_device).bfloat16()
    before = dict(ops.FLASH_ROUTES)
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention(q, k, k.contiguous())
    assert ops.FLASH_ROUTES == before


@pytest.mark.cuda
@pytest.mark.parametrize("C", [2, 5, 16, 32])
@pytest.mark.parametrize("P", [1_000_000, 4099])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_weighted_agg_small_c_kernel_matches_plain(cuda_device, C, P, dt):
    """The streaming small-C kernel (16-byte rows; one element a thread
    where P is ragged), at the reference sweep's tolerances."""
    from repro_torch.kernels import weighted_agg as wagg
    pl = wagg.plan(C, P, k=1, vec4=P % 8 == 0)
    assert isinstance(pl, wagg.SmallC)
    g = torch.Generator(device=cuda_device).manual_seed(C * P)
    s = torch.randn((C, P), generator=g, device=cuda_device).to(dt)
    w = torch.rand((C,), generator=g, device=cuda_device)
    got = ops.weighted_agg(s, w)
    torch.cuda.synchronize()
    tol = 1e-5 if dt == torch.float32 else 3e-2
    torch.testing.assert_close(got.float(), ref.weighted_agg_ref(s, w).float(),
                               rtol=tol, atol=tol)


MESH_ONE_RANK = """
import sys
import torch
import torch.distributed as dist
from repro_torch import api
from repro_torch.kernels import ops
from repro_torch.launch import mesh as mesh_lib
sc = api.Scenario(
    method="fedhc",
    data=api.DataSpec(samples_per_client=32, eval_size=128),
    fleet=api.FleetSpec(num_clients=32, num_clusters=3, round_minutes=4.0,
                        dropout_threshold=0.2),
    train=api.TrainSpec(rounds=8, rounds_per_global=4, eval_every=4,
                        local_steps=1, batch_size=16),
    exec=api.ExecSpec(use_pallas_kernels=True))
ops.reset_launches()
single = api.run(sc, device="cuda")
want = dict(ops.LAUNCHES)
mesh_lib.init_process_group("cuda", init_method="file://" + sys.argv[1],
                            rank=0, world_size=1)
ops.reset_launches()
res = api.run(sc.replace(exec=api.ExecSpec(use_pallas_kernels=True,
                                           mesh_devices=0)), device="cuda")
dist.destroy_process_group()
assert res.mesh_shape == {"clients": 1}, res.mesh_shape
assert res.to_history() == single.to_history()
assert dict(ops.LAUNCHES) == want and want["weighted_agg_multi"] >= 8, want
print("ok")
"""


@pytest.mark.cuda
def test_one_rank_nccl_mesh_is_the_single_device_run(cuda_device, tmp_path):
    """A client mesh of one NCCL rank gives the one-device history with
    ``==`` and the same kernel launches (a fresh process: the process
    group is global state)."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", MESH_ONE_RANK, str(tmp_path / "store")],
        cwd=root, env=dict(os.environ, PYTHONPATH=os.path.join(root, "src")),
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")


@pytest.mark.cuda
def test_grouped_kernel_past_2_31_stacked_elements(cuda_device):
    """A tree whose big leaf holds more than 2^31 stacked elements (as
    gemma2-2b's embedding over 4 clients does), bf16, C = 4, K = 2, in
    column chunks (the plain version's f32 copy of the whole leaf would be
    9 GB).  Every element within one bf16 ulp of the f32-accumulated plain
    sum, plus the bound of a C-term f32 sum taken in another order (2 C
    f32 ulps of sum |w x|): random rows cancel, and where a sum cancels to
    near 0 its bf16 ulp is smaller than the f32 rounding of its terms."""
    c, k, big = 4, 2, (1 << 29) + 4099          # 4 * big > 2^31
    g = torch.Generator(device=cuda_device).manual_seed(7)
    leaves = (torch.randn((c, 2304), generator=g, device=cuda_device)
              .bfloat16(),
              torch.randn((c, big), generator=g, device=cuda_device)
              .bfloat16(),
              torch.randn((c, 13), generator=g, device=cuda_device)
              .bfloat16())
    assert leaves[1].numel() > 2**31
    w = torch.rand((c, k), generator=g, device=cuda_device)
    w = (w / w.sum(0, keepdim=True)).contiguous()
    before = ops.LAUNCHES["weighted_agg_multi"]
    got = ops.weighted_agg_multi_tree(leaves, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["weighted_agg_multi"] == before + 1
    chunk = 1 << 26
    for out, x in zip(got, leaves):
        assert out.shape == (k, x.shape[1]) and out.dtype == torch.bfloat16
        for a in range(0, x.shape[1], chunk):
            xs = x[:, a:a + chunk].float()
            want = w.T @ xs
            _, e = torch.frexp(want)
            ulp = (torch.ldexp(torch.ones_like(want), (e - 8).clamp_min(-133))
                   + 2 * c * 2.0**-24 * (w.T @ xs.abs()))
            err = (out[:, a:a + chunk].float() - want).abs()
            assert bool((err <= ulp).all()), float((err / ulp).max())
            ref_out = ref.weighted_agg_multi_ref(x[:, a:a + chunk], w)
            assert float((out[:, a:a + chunk].float()
                          - ref_out.float()).abs().max()) <= float(
                ulp.max())


@pytest.mark.cuda
def test_flash_attention_at_recurrentgemma_local_layers(cuda_device):
    """recurrentgemma-2b's local layer shape at a shortened length: Hq = 10
    over Hkv = 1 (group 10), D = 256, window 2048 < S, no soft-cap, from
    the model's (B, S, H, D) layout (the size-1 head dimension's stride
    set for TMA), on the tensor cores.  Held at chip_smoke's layer bars
    (rtol 1e-2, atol 1e-3): outputs are ~0.02 here, so the sweep's 4e-2
    would pass a dropped kv tile."""
    g = torch.Generator(device=cuda_device).manual_seed(8)
    q, k, v = (torch.randn((1, 2600, h, 256), generator=g,
                           device=cuda_device).bfloat16().transpose(1, 2)
               for h in (10, 1, 1))
    before = dict(ops.FLASH_ROUTES)
    got = ops.flash_attention(q, k, v, window=2048)
    torch.cuda.synchronize()
    assert ops.FLASH_ROUTES["tensor_cores"] == before["tensor_cores"] + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    want = ref.flash_attention_ref(q, k, v, window=2048)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-2b"])
def test_recurrent_serving_on_the_card_matches_the_cpu(cuda_device, arch):
    """The smoke variant (f32) on the card against the same parameters on
    the CPU: ``prefill_last`` past recurrentgemma's 64-token window, then
    two decode steps, logits and caches at 1e-4 (float32 on both sides,
    summed in other orders; the local layers' prefill runs the f32 flash
    kernel on the card, its plain version on the CPU)."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import decode_step, init_params
    from repro_torch.models.model import prefill_last
    from repro_torch.tree import tree_leaves, tree_map
    cfg = smoke_variant(get_config(arch))
    gen = torch.Generator().manual_seed(9)
    cpu = init_params(cfg, gen)
    card = tree_map(lambda t: t.to(cuda_device), cpu)
    toks = torch.randint(0, cfg.vocab_size, (2, 100), generator=gen)
    outs = {}
    with torch.inference_mode():
        for name, params, dev in (("cpu", cpu, "cpu"),
                                  ("card", card, cuda_device)):
            t = toks.to(dev)
            logits, caches = prefill_last(cfg, params, {"tokens": t}, 104)
            seq = [logits]
            for step in range(2):
                logits, caches = decode_step(cfg, params, caches,
                                             toks[:, step:step + 1].to(dev),
                                             100 + step)
                seq.append(logits[:, 0])
            outs[name] = [x.cpu() for x in seq + tree_leaves(caches)]
    for a, b in zip(outs["card"], outs["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [0, 300])
def test_flash_attention_at_moe_layers(cuda_device, window):
    """grok-1-314b's and mixtral-8x22b's layer shape at a shortened
    length: Hq = 48 over Hkv = 8 (group 6), D = 128, causal, window 0
    (grok-1) or shorter than S (mixtral's 4096, scaled), bf16, from the
    model's (B, S, H, D) layout, on the tensor cores, at chip_smoke's
    layer bars (rtol 1e-2, atol 1e-3)."""
    g = torch.Generator(device=cuda_device).manual_seed(10 + window)
    q, k, v = (torch.randn((2, 700, h, 128), generator=g,
                           device=cuda_device).bfloat16().transpose(1, 2)
               for h in (48, 8, 8))
    before = dict(ops.FLASH_ROUTES)
    got = ops.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert ops.FLASH_ROUTES["tensor_cores"] == before["tensor_cores"] + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    want = ref.flash_attention_ref(q, k, v, window=window)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-3)


@pytest.mark.cuda
def test_stage1_tree_of_two_dtypes_on_the_card(cuda_device):
    """A bf16 tree with f32 leaves (the recurrent families' ``A_log``,
    ``D``, ``dt_bias``): one grouped launch a dtype, each leaf against the
    plain version in its own dtype."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    leaves = tuple(torch.randn((4, p), generator=g, device=cuda_device)
                   .to(dt) for p, dt in ((5000, torch.bfloat16),
                                         (64, torch.float32),
                                         (3000, torch.bfloat16),
                                         (48, torch.float32)))
    w = torch.rand((4, 2), generator=g, device=cuda_device)
    w = (w / w.sum(0, keepdim=True)).contiguous()
    before = ops.LAUNCHES["weighted_agg_multi"]
    got = ops.weighted_agg_multi_tree(leaves, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["weighted_agg_multi"] == before + 2
    for out, x in zip(got, leaves):
        assert out.dtype == x.dtype and out.shape == (2, x.shape[1])
        tol = 2e-5 if x.dtype == torch.float32 else 3e-2
        torch.testing.assert_close(out.float(), ref.weighted_agg_multi_ref(
            x, w).float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch", ["scan", "capacity", "dense"])
def test_moe_dispatch_on_the_card_matches_the_cpu(cuda_device, dispatch):
    """The smoke mixtral-8x22b's MoE layer (f32, TF32 off) on the card
    against the same parameters and input on the CPU: output and aux at
    1e-5."""
    from repro_torch import device as device_lib
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import moe
    from repro_torch.tree import tree_map
    device_lib.resolve("cuda")                  # TF32 off
    cfg = smoke_variant(get_config("mixtral-8x22b"))
    gen = torch.Generator().manual_seed(12)
    p = moe.init_moe(cfg, gen, torch.float32, "cpu")
    x = 0.5 * torch.randn((2, 40, cfg.d_model), generator=gen)
    want = moe.apply_moe(cfg, p, x, dispatch)
    got = moe.apply_moe(cfg, tree_map(lambda t: t.to(cuda_device), p),
                        x.to(cuda_device), dispatch)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_int8_decode_on_the_card_matches_the_cpu(cuda_device):
    """The smoke grok-1-314b (f32 weights, int8 KV cache, scan dispatch)
    on the card against the CPU.  ``prefill_last``: logits and the
    caches' scales at 1e-4, their int8 values at most 4 a leaf one step
    apart (the K/V the two devices quantize are summed in other orders,
    and a value within an f32 ulp of a half rounds either way).  Then two
    decode steps, each from the same (the CPU's) caches on both devices,
    so that a flipped int8 value, which moves every logit of its sequence
    by ~1e-4, does not carry over: logits at 1e-4."""
    from repro_torch import device as device_lib
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import decode_step, init_params
    from repro_torch.models.model import prefill_last
    from repro_torch.tree import tree_leaves, tree_map
    device_lib.resolve("cuda")
    cfg = smoke_variant(get_config("grok-1-314b"))
    gen = torch.Generator().manual_seed(13)
    cpu = init_params(cfg, gen)
    card = tree_map(lambda t: t.to(cuda_device), cpu)
    toks = torch.randint(0, cfg.vocab_size, (2, 100), generator=gen)
    with torch.inference_mode():
        lc, cc = prefill_last(cfg, cpu, {"tokens": toks}, 104,
                              dispatch="scan", quantized_cache=True)
        lg, cg = prefill_last(cfg, card, {"tokens": toks.to(cuda_device)},
                              104, dispatch="scan", quantized_cache=True)
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4)
        n_int8 = 0
        for a, b in zip(tree_leaves(cg), tree_leaves(cc)):
            a = a.cpu()
            if a.dtype == torch.int8:
                n_int8 += 1
                d = (a.int() - b.int()).abs()
                assert int(d.max()) <= 1 and int((d > 0).sum()) <= 4
            else:
                torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        assert n_int8 == 2             # k and v, stacked over the 2 layers
        for step in range(2):
            cg = tree_map(lambda t: t.to(cuda_device), cc)
            tok = toks[:, step:step + 1]
            lc, cc = decode_step(cfg, cpu, cc, tok, 100 + step,
                                 dispatch="scan")
            lg, cg = decode_step(cfg, card, cg, tok.to(cuda_device),
                                 100 + step, dispatch="scan")
            torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-4,
                                       msg=f"decode step {step}")


@pytest.mark.cuda
@pytest.mark.parametrize("sq", [100, 1])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_flash_attention_cross_non_causal(cuda_device, sq, dt):
    """whisper's cross-attention shape, cut in batch: Sq = 100 or 1 query
    rows (1 live row in a 128-row tile) against Sk = 1500 = 23 * 64 + 28
    keys with no mask, K/V from (B, Sk, H, D) views as the model hands
    them over; at the sweep's bars (3e-5 f32, 4e-2 bf16)."""
    g = torch.Generator(device=cuda_device).manual_seed(10 + sq)
    q = torch.randn((2, sq, 20, 64), generator=g, device=cuda_device)
    kv = torch.randn((2, 1500, 2, 20, 64), generator=g, device=cuda_device)
    q, k, v = (t.to(dt).transpose(1, 2) for t in (q, kv[:, :, 0],
                                                  kv[:, :, 1]))
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    assert got.shape == q.shape and got.dtype == dt
    want = ref.flash_attention_ref(q, k, v, causal=False)
    tol = 3e-5 if dt == torch.float32 else 4e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["whisper-large-v3", "pixtral-12b"])
def test_frontend_serving_on_the_card_matches_the_cpu(cuda_device, arch):
    """The smoke variant (f32) on the card against the same parameters on
    the CPU, through ``serve_batch``'s path: whisper encodes its frames
    (flash, non-causal) and every prefill and decode step attends over
    them (flash, Sq = 40 and 1); pixtral's 32 patches lead the prompt.
    ``prefill_last`` then two decode steps: logits and caches at 1e-4
    (float32 on both sides, summed in other orders)."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.models import decode_step, init_params
    from repro_torch.models.model import prefill_last
    from repro_torch.models.transformer import encode
    from repro_torch.tree import tree_leaves, tree_map
    cfg = smoke_variant(get_config(arch))
    gen = torch.Generator().manual_seed(11)
    cpu = init_params(cfg, gen)
    card = tree_map(lambda t: t.to(cuda_device), cpu)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen)
    front = 0.1 * torch.randn((2, cfg.frontend_len, cfg.d_model),
                              generator=gen)
    off = 0 if cfg.is_enc_dec else cfg.frontend_len
    outs = {}
    with torch.inference_mode():
        for name, params, dev in (("cpu", cpu, "cpu"),
                                  ("card", card, cuda_device)):
            before = ops.LAUNCHES["flash_attention"]
            batch, enc = {"tokens": toks.to(dev)}, None
            if cfg.is_enc_dec:
                enc = encode(cfg, params, front.to(dev), mode="prefill")
                batch["enc_out"] = enc
            else:
                batch["patch_embeds"] = front.to(dev)
            logits, caches = prefill_last(cfg, params, batch, off + 44)
            seq = [logits] + ([enc] if enc is not None else [])
            for step in range(2):
                logits, caches = decode_step(cfg, params, caches,
                                             toks[:, step:step + 1].to(dev),
                                             off + 40 + step, enc_out=enc)
                seq.append(logits[:, 0])
            outs[name] = [x.cpu() for x in seq + tree_leaves(caches)]
            launches = ops.LAUNCHES["flash_attention"] - before
        n = cfg.num_layers
        assert launches == (cfg.encoder_layers + 2 * n + 2 * n
                            if cfg.is_enc_dec else n)
    for a, b in zip(outs["card"], outs["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def _tp_prefill_rank(rank: int, world: int, out: str,
                     arch: str = "gemma2-2b") -> None:
    """One rank of a (1, 2) mesh on the one card (gloo): the smoke
    ``arch`` in bf16 (its profile's MoE dispatch and KV cache), its
    blocks of the model, the mesh program's prefill with the counts set
    to 0 just before it, and one device's prefill of the same model; the
    rank's vocab slice of both to ``out``."""
    from repro_torch.configs import (get_config, get_profile, replace,
                                     smoke_variant)
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import steps
    from repro_torch.models import init_params
    from repro_torch.models.model import prefill_last
    from repro_torch.sharding import rules
    mesh = mesh_lib.make_mesh((1, 2), device_type="cuda")
    cfg = replace(smoke_variant(get_config(arch)), dtype="bfloat16")
    prof = get_profile(arch)
    serve = dict(dispatch=prof.moe_dispatch, quantized_cache=prof.kv_int8)
    gen = torch.Generator(device="cuda").manual_seed(3)
    full = init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen,
                         device="cuda")
    local = rules.local_shard(full, steps.param_specs(cfg, prof, mesh), mesh)
    tp = steps.mesh_program(mesh, prof)
    with torch.inference_mode():
        want, _ = prefill_last(cfg, full, {"tokens": toks}, 256, **serve)
        ops.reset_launches()
        got, _ = prefill_last(cfg, local, {"tokens": toks}, 256, tp=tp,
                              **serve)
        torch.cuda.synchronize()
    v = got.shape[-1]
    torch.save({"got": got.float().cpu(),
                "want": want[:, tp.rank * v:(tp.rank + 1) * v].float().cpu(),
                "launches": dict(ops.LAUNCHES), "layers": cfg.num_layers},
               f"{out}.{rank}.pt")


@pytest.mark.cuda
def test_tensor_parallel_prefill_on_the_card(cuda_device, tmp_path):
    """Two ranks sharing the card over gloo, tensor parallelism over
    "model" (smoke gemma2-2b, bf16): each rank's vocab slice of the
    last-position logits within the bf16 serving bar (0.1, as
    ``test_torch_transformer.py``'s bf16 models) of one device's, and
    every layer's prefill through the flash kernel on each rank's
    heads."""
    from repro_torch.launch import mesh as mesh_lib
    out = str(tmp_path / "tp")
    mesh_lib.spawn_ranks(_tp_prefill_rank, 2, (out,), device_type="cuda",
                         timeout_s=600)
    for r in range(2):
        res = torch.load(f"{out}.{r}.pt")
        assert res["got"].shape == res["want"].shape
        assert torch.isfinite(res["got"]).all()
        assert (res["got"] - res["want"]).abs().max() <= 0.1
        assert res["launches"]["flash_attention"] == res["layers"]


@pytest.mark.cuda
def test_tensor_parallel_moe_prefill_on_the_card(cuda_device, tmp_path):
    """The same for grok-1-314b's smoke variant (per-expert TP over
    "model", the scan dispatch, the int8 cache): each rank's vocab slice
    within 0.1 of one device's (the mesh sums a rank's experts in float32
    where one device adds them in bf16), every layer through the flash
    kernel on each rank's heads."""
    from repro_torch.launch import mesh as mesh_lib
    out = str(tmp_path / "tp_moe")
    mesh_lib.spawn_ranks(_tp_prefill_rank, 2, (out, "grok-1-314b"),
                         device_type="cuda", timeout_s=600)
    for r in range(2):
        res = torch.load(f"{out}.{r}.pt")
        assert res["got"].shape == res["want"].shape
        assert torch.isfinite(res["got"]).all()
        assert (res["got"] - res["want"]).abs().max() <= 0.1
        assert res["launches"]["flash_attention"] == res["layers"]


@pytest.mark.cuda
def test_tensor_parallel_ssd_prefill_on_the_card(cuda_device, tmp_path):
    """The same for mamba2-1.3b's smoke variant (the SSD by heads, its
    projection and conv cut part by part, the gated norm's sum of
    squares summed over "model"): each rank's vocab slice within 0.1 of
    one device's, and no flash launch (the model has no attention)."""
    from repro_torch.launch import mesh as mesh_lib
    out = str(tmp_path / "tp_ssd")
    mesh_lib.spawn_ranks(_tp_prefill_rank, 2, (out, "mamba2-1.3b"),
                         device_type="cuda", timeout_s=600)
    for r in range(2):
        res = torch.load(f"{out}.{r}.pt")
        assert res["got"].shape == res["want"].shape
        assert torch.isfinite(res["got"]).all()
        assert (res["got"] - res["want"]).abs().max() <= 0.1
        assert res["launches"]["flash_attention"] == 0
