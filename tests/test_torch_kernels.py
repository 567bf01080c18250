"""The port's kernel modules against the JAX reference.

On the CPU the dispatching wrappers (`repro_torch/kernels/ops.py`) take the
plain PyTorch versions; those are held against ``repro/kernels/ref.py`` and
the interpreted Pallas kernels on the sweeps of ``tests/test_kernels.py``,
at its tolerances.  The CUDA kernels themselves are held against the plain
versions in ``tests/test_torch_cuda.py`` (skipped without a card) and by
``chip_smoke.py`` on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops
from repro_torch.kernels import ref as ref_torch
from repro_torch.kernels import weighted_agg as wagg_launcher
from repro_torch.tree import tree_leaves


torch.set_num_threads(1)        # see test_torch_jaxref.py


def _rng(*key):
    return np.random.default_rng(list(key))


# ------------------------------------------------------ weighted_agg_multi

@pytest.mark.parametrize("C,P,K", [(4, 100, 2), (16, 3000, 5), (12, 2048, 8)])
def test_weighted_agg_multi_plain_matches_reference(C, P, K):
    """Plain version == the JAX einsum oracle == the interpreted Pallas
    kernel == K single-weight Pallas reductions (2e-5)."""
    g = _rng(C, P, K)
    s = g.standard_normal((C, P)).astype(np.float32)
    w = g.uniform(size=(C, K)).astype(np.float32)
    got = ops.weighted_agg_multi(torch.from_numpy(s),
                                 torch.from_numpy(w)).numpy()
    want = np.asarray(jref.weighted_agg_multi_ref(jnp.asarray(s),
                                                  jnp.asarray(w)))
    pallas = np.asarray(jops.weighted_agg_multi(jnp.asarray(s),
                                                jnp.asarray(w),
                                                interpret=True))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-5)
    for k in range(K):
        one = np.asarray(jops.weighted_agg(jnp.asarray(s),
                                           jnp.asarray(w[:, k]),
                                           interpret=True))
        np.testing.assert_allclose(got[k], one, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("C,P", [(2, 64), (16, 1000), (8, 4096), (5, 17)])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_weighted_agg_multi_dtypes(C, P, dt):
    """f32 and bf16 stacks, f32 accumulation, output in the stack's dtype
    (the dtype sweep of tests/test_kernels.py, at its tolerances)."""
    g = _rng(C, P)
    s = g.standard_normal((C, P)).astype(np.float32)
    w = g.uniform(size=(C, 3)).astype(np.float32)
    ts = torch.from_numpy(s).to(getattr(torch, dt))
    got = ops.weighted_agg_multi(ts, torch.from_numpy(w))
    assert got.dtype == ts.dtype and got.shape == (3, P)
    want = jref.weighted_agg_multi_ref(jnp.asarray(s).astype(dt),
                                       jnp.asarray(w))
    tol = 1e-5 if dt == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_weighted_agg_multi_tree_is_leafwise():
    g = _rng(7)
    tree = {"a": {"w": torch.from_numpy(
                g.standard_normal((4, 3, 5)).astype(np.float32))},
            "b": torch.from_numpy(g.standard_normal((4, 7)).astype(np.float32))}
    w = torch.from_numpy(g.uniform(size=(4, 2)).astype(np.float32))
    got = ops.weighted_agg_multi_tree(tree, w)
    assert got["a"]["w"].shape == (2, 3, 5) and got["b"].shape == (2, 7)
    want = np.einsum("c...,ck->k...", tree["a"]["w"].numpy(), w.numpy())
    np.testing.assert_allclose(got["a"]["w"].numpy(), want, rtol=2e-5,
                               atol=2e-5)


# ----------------------------------------------------------- kmeans_assign

@pytest.mark.parametrize("N,D,K", [(100, 3, 4), (513, 10, 7), (64, 128, 16),
                                   (1000, 3, 5)])
def test_kmeans_assign_plain_matches_reference(N, D, K):
    """Exact assignment, and the min distance at tests/test_kernels.py's
    tolerance, against the JAX oracle and the interpreted Pallas kernel."""
    g = _rng(N, D, K)
    x = g.standard_normal((N, D)).astype(np.float32)
    c = g.standard_normal((K, D)).astype(np.float32)
    a, d = ops.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c))
    assert a.dtype == torch.int32 and d.dtype == torch.float32
    for ja, jd in (jref.kmeans_assign_ref(jnp.asarray(x), jnp.asarray(c)),
                   jops.kmeans_assign(jnp.asarray(x), jnp.asarray(c),
                                      interpret=True)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-4,
                                   atol=1e-4)


def test_kmeans_assign_ties_take_first_index():
    x = torch.zeros((4, 3))
    c = torch.tensor([[1.0, 0, 0], [0, 1.0, 0], [1.0, 0, 0]])
    a, d = ops.kmeans_assign(x, c)
    assert a.tolist() == [0, 0, 0, 0]
    assert d.tolist() == [1.0] * 4


# --------------------------------------------------- dispatch and the build

def test_cpu_tensors_take_the_plain_path_and_count_nothing():
    ops.reset_launches()
    ops.weighted_agg_multi(torch.ones((3, 5)), torch.ones((3, 2)))
    ops.kmeans_assign(torch.ones((3, 3)), torch.ones((2, 3)))
    assert set(ops.LAUNCHES.values()) == {0}


def test_non_cpu_tensors_never_fall_back_to_the_plain_path():
    """A tensor that is not on the CPU must launch the kernel or raise:
    here a meta tensor is refused by the launcher's device check."""
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.weighted_agg_multi(torch.empty((3, 5), device=meta),
                               torch.empty((3, 2), device=meta))
    with pytest.raises(ValueError, match="CUDA"):
        ops.kmeans_assign(torch.empty((3, 3), device=meta),
                          torch.empty((2, 3), device=meta))
    assert set(ops.LAUNCHES.values()) == {0}


def test_build_without_nvcc_raises_a_clear_error(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(build, "DEFAULT_NVCC", tmp_path / "nvcc")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("weighted_agg")
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("c,p,vec4,want", [
    (800, 30720, True, (4, 240)),    # LeNet f1.w: 240 column tiles
    (800, 10080, True, (4, 79)),     # f2.w: 79 tiles
    (800, 6, False, (1, 1)),         # a bias: one tile of one element a lane
    (32, 150, False, (1, 5)),        # c1.w: unaligned, 5 tiles
    (16, 3000, False, (1, 94)),
])
def test_weighted_agg_launch_plan(c, p, vec4, want):
    """One leaf: (elements a lane, blocks), a block for every column tile
    of 32 lanes, whatever C (a block's 8 warps share the rows)."""
    pl = wagg_launcher.plan(c, p, vec4=vec4)
    assert (pl.vec[0], pl.blocks) == want
    assert pl.tiles == (pl.blocks,) and pl.first == (0,)
    assert (pl.blocks - 1) * 32 * pl.vec[0] < p <= pl.blocks * 32 * pl.vec[0]


@pytest.mark.parametrize("c,k,vec4,want", [
    (16, 1, True, wagg_launcher.SmallC(16)),     # kernel_bench's C = 16
    (32, 1, True, wagg_launcher.SmallC(16)),
    (5, 1, False, wagg_launcher.SmallC(1)),      # ragged P: one element
    (33, 1, True, (4, 240)),                     # past the small-C threshold
    (800, 4, True, (4, 240)),                    # f1.w of a stage-1
    (16, 4, True, (4, 240)),                     # K > 1: the grouped kernel
])
def test_weighted_agg_plan_picks_the_small_c_kernel_for_k1(c, k, vec4, want):
    """K = 1 at C <= SMALL_C_MAX streams (wagg_small_c_kernel); every other
    shape takes the grouped kernel of the FL engine (elements a lane,
    blocks).  ``small_c_max`` only lowers the threshold: the small-C kernel
    takes at most SMALL_C_MAX rows."""
    pl = wagg_launcher.plan(c, 30720, k=k, vec4=vec4)
    if isinstance(want, wagg_launcher.SmallC):
        assert type(pl) is type(want) and pl == want
        assert isinstance(wagg_launcher.plan(c, 30720, k=k, vec4=vec4,
                                             small_c_max=0),
                          wagg_launcher.GroupedPlan)
    else:
        assert isinstance(pl, wagg_launcher.GroupedPlan)
        assert (pl.vec[0], pl.blocks) == want
    assert wagg_launcher.plan(800, 30720, k=4, vec4=True) == \
        wagg_launcher.plan(800, 30720, vec4=True)
    assert isinstance(wagg_launcher.plan(64, 30720, k=1, vec4=True,
                                         small_c_max=1000),
                      wagg_launcher.GroupedPlan)


# LeNet's leaves, per client: c1.w c1.b c2.w c2.b f1.w f1.b f2.w f2.b f3.w f3.b
LENET_P = [150, 6, 2400, 16, 30720, 120, 10080, 84, 840, 10]


def _blocks(pl, ps, k=None):
    """The plan's blocks, launch by launch, as csrc/weighted_agg.cu maps
    them: in a launch, block b takes pass b % passes of column tile
    t = b // passes, of the last leaf (in work order) whose first tile is
    <= t.  Yields (leaf, column lo, column hi, cluster lo, cluster hi),
    half-open and cut to the leaf and to ``k`` clusters."""
    k = pl.kmax * pl.passes if k is None else k
    for group in pl.groups:
        firsts = [pl.first[i] for i in group]
        grid = sum(pl.tiles[i] for i in group) * pl.passes
        for b in range(grid):
            tile, pas = divmod(b, pl.passes)
            leaf = group[max(j for j, f in enumerate(firsts) if f <= tile)]
            width = pl.lanes * pl.vec[leaf]
            t = tile - pl.first[leaf]
            yield (leaf, t * width, min(ps[leaf], (t + 1) * width),
                   pas * pl.kmax, min(k, (pas + 1) * pl.kmax))


def _warp_rows(c):
    """Rows of each warp of a block, in the order it sums them: warp w
    takes rows w, w + 8, ... (the kernel stages the weights in chunks of a
    multiple of 8 rows, which keeps that order)."""
    return [range(w, c, wagg_launcher.WARPS)
            for w in range(wagg_launcher.WARPS)]


def _lenet_aligned(dtype):
    """16-byte rows for separately allocated leaves: P * size % 16 == 0."""
    size = torch.empty((), dtype=dtype).element_size()
    return [(p * size) % 16 == 0 for p in LENET_P]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [1, 4, 16, 17, 32])
@pytest.mark.parametrize("C", [32, 800, 10_000])
def test_plan_grouped_covers_every_column_and_row_once(C, K, dtype):
    """Every (column, cluster) of every leaf in exactly one block, every
    row of a block in exactly one of its warps (so no warp walks all of C),
    and at C = 800 in f32 (the stage-1) at least two blocks for every SM of
    an H100 (132).  K <= 16 is one pass of the smallest bucket that holds
    it; K > 16 takes passes of 16 clusters."""
    pl = wagg_launcher.plan_grouped(LENET_P, C, K, dtype,
                                    _lenet_aligned(dtype))
    assert sorted(pl.order) == list(range(len(LENET_P)))
    assert pl.groups == (pl.order,) and pl.launches == 1
    if K <= 16:
        assert pl.kmax == min(b for b in (4, 8, 16) if K <= b)
        assert pl.passes == 1 and sum(pl.tiles) == pl.blocks
    else:
        assert pl.kmax == 16
        assert pl.passes == -(-K // pl.kmax)
        assert pl.blocks == sum(pl.tiles) * pl.passes
    cols = [np.zeros((K, p), np.int64) for p in LENET_P]
    for leaf, lo, hi, k0, k1 in _blocks(pl, LENET_P, K):
        assert 0 <= lo < hi <= LENET_P[leaf] and 0 <= k0 < k1 <= K
        assert hi - lo <= pl.lanes * pl.vec[leaf] and k1 - k0 <= pl.kmax
        cols[leaf][k0:k1, lo:hi] += 1
    for leaf, c in enumerate(cols):
        assert (c == 1).all(), leaf
    rows = np.zeros(C, np.int64)
    for r in _warp_rows(C):
        assert len(r) < C
        rows[list(r)] += 1
    assert (rows == 1).all()
    # narrow or unaligned leaves take one element a lane, the rest 16 bytes
    wide = 16 // torch.empty((), dtype=dtype).element_size()
    assert pl.vec == tuple(wide if a else 1 for a in _lenet_aligned(dtype))
    if dtype == torch.float32:                   # the FL stage-1
        assert pl.blocks >= 2 * 132


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K", [2, 16, 17])
@pytest.mark.parametrize("C", [1, 4, 8, 9])
def test_plan_grouped_small_c_gives_a_thread_every_row(C, K, dtype):
    """At C <= SMALL_C_ROWS (8) a column tile is THREADS lanes wide and
    each thread sums every row of its columns; at C = 9 the warps share
    the rows again over 32-lane tiles.  Every (column, cluster) of every
    leaf in exactly one block either way."""
    pl = wagg_launcher.plan_grouped(LENET_P, C, K, dtype,
                                    _lenet_aligned(dtype))
    small = C <= wagg_launcher.SMALL_C_ROWS
    assert pl.lanes == (wagg_launcher.THREADS if small else 32)
    assert pl.tiles == tuple(-(-p // (pl.lanes * v))
                             for p, v in zip(LENET_P, pl.vec))
    cols = [np.zeros((K, p), np.int64) for p in LENET_P]
    for leaf, lo, hi, k0, k1 in _blocks(pl, LENET_P, K):
        assert hi - lo <= pl.lanes * pl.vec[leaf]
        cols[leaf][k0:k1, lo:hi] += 1
    assert all((c == 1).all() for c in cols)


def test_plan_grouped_refuses_what_the_kernel_does_not_take():
    """Refused: an empty stack, mismatched flags, an unsupported dtype.
    Taken (they were refused before the kernel took any K and any number
    of leaves): a tree of 65 leaves, two launches of 64 and 1; K = 17, two
    passes of 16 clusters."""
    aligned = [True] * (wagg_launcher.MAX_LEAVES + 1)
    pl = wagg_launcher.plan_grouped([64] * len(aligned), 32, 4,
                                    torch.float32, aligned)
    assert pl.launches == 2 and [len(g) for g in pl.groups] == [64, 1]
    assert pl.groups[0] + pl.groups[1] == pl.order
    assert pl.first[pl.groups[1][0]] == 0          # its own launch's grid
    pl = wagg_launcher.plan_grouped([64], 32, 17, torch.float32, [True])
    assert (pl.kmax, pl.passes, pl.vec[0]) == (16, 2, 4)
    assert pl.blocks == pl.tiles[0] * pl.passes
    with pytest.raises(ValueError, match="K=0"):
        wagg_launcher.plan_grouped([64], 32, 0, torch.float32, [True])
    with pytest.raises(ValueError, match="empty"):
        wagg_launcher.plan_grouped([64, 0], 32, 4, torch.float32,
                                   [True, True])
    with pytest.raises(ValueError, match="alignment"):
        wagg_launcher.plan_grouped([64], 32, 4, torch.float32, [True, True])
    with pytest.raises(TypeError, match="dtype"):
        wagg_launcher.plan_grouped([64], 32, 4, torch.float16, [True])


def _emulate_grouped(stacks, w, pl):
    """The grouped kernel's arithmetic on the CPU: walk the plan's blocks
    (every launch, every pass); in a block, warp i accumulates its rows
    (i, i + 8, ...) in row order for the pass's clusters and the block sums
    its warps in warp order; at C <= 8 each thread sums all rows in row
    order.  f32 throughout, output in the stack's dtype."""
    c, k = w.shape
    ps = [x.shape[1] for x in stacks]
    outs = [torch.zeros((k, p)) for p in ps]
    warps = wagg_launcher.WARPS
    for leaf, lo, hi, k0, k1 in _blocks(pl, ps, k):
        x = stacks[leaf][:, lo:hi].float()
        wk = w[:, k0:k1]
        if pl.lanes == wagg_launcher.THREADS:   # C <= 8: a thread, all rows
            block = torch.zeros((k1 - k0, hi - lo))
            for j in range(c):
                block = block + wk[j, :, None] * x[j, None, :]
            outs[leaf][k0:k1, lo:hi] = block
            continue
        acc = torch.zeros((warps, k1 - k0, hi - lo))
        for j in range(0, c, warps):            # row j + i to warp i
            n = min(warps, c - j)
            acc[:n] = acc[:n] + wk[j:j + n, :, None] * x[j:j + n, None, :]
        block = torch.zeros((k1 - k0, hi - lo))
        for i in range(warps):
            block = block + acc[i]
        outs[leaf][k0:k1, lo:hi] = block
    return [o.to(x.dtype) for o, x in zip(outs, stacks)]


@pytest.mark.parametrize("C,K,dt,ps", [
    (40, 4, "float32", LENET_P),
    (300, 4, "float32", LENET_P),
    (100, 1, "float32", LENET_P),
    (130, 16, "float32", LENET_P),
    (200, 4, "bfloat16", LENET_P),
    (60, 17, "float32", LENET_P),            # two passes of 16
    (60, 17, "bfloat16", LENET_P),
    (60, 32, "float32", LENET_P),
    (60, 32, "bfloat16", LENET_P),
    (45, 40, "float32", LENET_P),            # three passes, the last of 8
    (24, 4, "float32", [40 + 3 * i for i in range(65)]),   # 2 launches
    (24, 17, "bfloat16", [8 * (i % 5 + 1) for i in range(65)]),
    (4, 2, "bfloat16", LENET_P),             # C <= 8: a thread, all rows
    (8, 17, "float32", LENET_P),
    (1, 4, "float32", LENET_P),
    (5, 16, "bfloat16", [8 * (i % 5 + 1) for i in range(65)]),
])
def test_grouped_kernel_order_matches_plain(C, K, dt, ps):
    """The CPU emulation of the kernel's summation order equals the plain
    version on random leaves (LeNet's, or 65 of them: two launches), at K
    up to 40 in passes of 16 clusters (2e-5 f32, 3e-2 bf16, the
    tolerances of tests/test_kernels.py), with weights normalized per
    cluster as the engine's are."""
    g = _rng(C, K, 3)
    dtype = getattr(torch, dt)
    stacks = [torch.from_numpy(g.standard_normal((C, p)).astype(np.float32)
                               ).to(dtype) for p in ps]
    w = g.uniform(size=(C, K)).astype(np.float32)
    w = torch.from_numpy(w / w.sum(0, keepdims=True))
    size = torch.empty((), dtype=dtype).element_size()
    pl = wagg_launcher.plan_grouped(ps, C, K, dtype,
                                    [(p * size) % 16 == 0 for p in ps])
    assert pl.launches == wagg_launcher.launches(len(ps))
    got = _emulate_grouped(stacks, w, pl)
    tol = 2e-5 if dt == "float32" else 3e-2
    for out, x in zip(got, stacks):
        want = ref_torch.weighted_agg_multi_ref(x, w)
        assert out.dtype == want.dtype and out.shape == want.shape
        np.testing.assert_allclose(out.float().numpy(), want.float().numpy(),
                                   rtol=tol, atol=tol)


def test_weighted_agg_multi_tree_matches_the_reference_tree():
    """The port's tree form against the reference's (interpreted Pallas,
    one call per leaf) on LeNet-shaped leaves at C = 16, K = 4 (2e-5)."""
    from repro_torch.models.lenet import init_lenet
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten
    like = init_lenet(torch.Generator().manual_seed(0), device="cpu")
    g = _rng(16, 4)
    arrays = [g.standard_normal((16,) + tuple(x.shape)).astype(np.float32)
              for x in tree_leaves(like)]
    w = g.uniform(size=(16, 4)).astype(np.float32)
    got = ops.weighted_agg_multi_tree(
        tree_unflatten(like, [torch.from_numpy(a) for a in arrays]),
        torch.from_numpy(w))
    want = jops.weighted_agg_multi_tree(
        tree_unflatten(like, [jnp.asarray(a) for a in arrays]),
        jnp.asarray(w), interpret=True)
    def same(a, b, x):              # leaf by key: jax orders keys sorted
        assert a.shape == (4,) + x.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-5)
    tree_map(same, got, want, like)


def test_every_source_is_built_under_a_content_hash():
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()
        p = build._lib_path(name)
        assert p.parent == build.BUILD_DIR and p.name.startswith(f"lib{name}-")
    # the hash covers each source's own flags: the -ldl of the tensor-core
    # flash kernel changes its library's name, not the others'
    assert "flash_attention_sm90" in build.SOURCES
    assert "-ldl" in build._flags("flash_attention_sm90")
    assert "-ldl" not in build._flags("flash_attention")


def test_ptxas_info_reads_registers_and_spills(monkeypatch, tmp_path):
    """The build phase's report: ptxas -v's lines for each kernel."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    build._lib_path("kmeans").with_suffix(".log").write_text(
        "ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3fooPf\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 168 registers, 1024 bytes smem, 392 bytes "
        "cmem[0]\n"
        "ptxas warning : (C7508) setmaxnreg ignored\n")
    rows = build.ptxas_info("kmeans")
    assert rows[0] == {"kernel": "_Z3fooPf", "registers": 168,
                       "static_smem": 1024, "spill_stores": 8,
                       "spill_loads": 4}
    assert "setmaxnreg ignored" in rows[1]["warnings"][0]


def test_stage1_tree_of_two_dtypes_takes_one_launch_a_dtype(monkeypatch):
    """A bf16 model with f32 leaves (mamba2's ``A_log``, ``D``,
    ``dt_bias``; recurrentgemma's RG-LRU gates): the grouped launch takes
    one dtype (``launch_grouped`` raises on two), so the tree goes in as
    one launch a dtype, each output back in its leaf's place.  Meta
    tensors reach the card's branch; the launcher is a stand-in that
    refuses as the real one does."""
    calls = []

    def fake(leaves, weights):
        assert len({x.dtype for x in leaves}) == 1, "one dtype a launch"
        calls.append([tuple(x.shape) for x in leaves])
        return [torch.empty((weights.shape[1],) + tuple(x.shape[1:]),
                            dtype=x.dtype, device=x.device) for x in leaves]
    monkeypatch.setattr(ops._wagg, "launch_grouped", fake)
    meta = torch.device("meta")
    tree = {"a": torch.empty((4, 6, 8), dtype=torch.bfloat16, device=meta),
            "A_log": torch.empty((4, 6), dtype=torch.float32, device=meta),
            "b": (torch.empty((4, 5), dtype=torch.bfloat16, device=meta),
                  torch.empty((4, 3), dtype=torch.float32, device=meta))}
    w = torch.empty((4, 2), dtype=torch.float32, device=meta)
    assert ops.dtype_groups(tree_leaves(tree)) == ((0, 2), (1, 3))
    ops.reset_launches()
    out = ops.weighted_agg_multi_tree(tree, w)
    assert ops.LAUNCHES["weighted_agg_multi"] == 2
    assert calls == [[(4, 6, 8), (4, 5)], [(4, 6), (4, 3)]]
    assert out["a"].shape == (2, 6, 8) and out["a"].dtype == torch.bfloat16
    assert out["A_log"].shape == (2, 6)
    assert out["A_log"].dtype == torch.float32
    assert out["b"][1].shape == (2, 3) and out["b"][1].dtype == torch.float32
    ops.reset_launches()
