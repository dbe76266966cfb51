"""The port's kernel wrappers on the CPU: each plain version against the
JAX package's reference (``repro/kernels/ref.py``) on the same numpy
inputs, and the wrappers' refusals.  ``test_torch_gpu.py`` holds each CUDA
kernel against its plain version on the card.

Tolerances: the W8A8 product is bit-identical (exact integer sums, the
same float32 epilogue order); attention with float32 queries agrees to
``atol = rtol = 1e-5`` (float32 sums taken in another order).  Against
the Pallas kernels run in interpret mode, which keep the softmax
probabilities in float32 where the plain versions round them to bf16
before the PV product on bf16 caches, each output vector (row, query,
head) agrees to ``1e-2`` of its own largest magnitude.  XLA's CPU
backend cannot run the JAX verify oracle on bf16 pages (its bf16 x bf16
-> f32 PV product, ROADMAP C1), so the verify sweeps hold float32 pages
of bf16-representable values, and the bf16 rounding of the probabilities
is held against the JAX decode oracle through a one-position verify.

``ln_res`` (the Fused LN&Res kernel) against the reference and its
Pallas kernel in interpret mode: the new residual bit-identical (one
float32 add, one cast), ``scale`` within 1e-5 relative, ``y`` within one
bf16 ulp per element, ``y_q`` within 1 everywhere and equal on at least
99.9% of elements (the port divides by an IEEE square root where the
reference multiplies by ``rsqrt``, and takes the means in another order,
so a value on a rounding boundary may land one step apart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import bridge
from repro_torch.kernels import build, ops

ATOL = RTOL = 1e-5

_jpaged_mha = jax.jit(jref.paged_mha_decode_ref, static_argnames="window")
_jpaged_verify = jax.jit(jref.paged_verify_ref, static_argnames="window")
#: per output vector, plain (bf16 probabilities) vs interpret (float32)
VEC_REL_TOL = 1e-2


def _vec_rel_err(got: np.ndarray, want: np.ndarray) -> float:
    """The largest error of an output vector (the last axis) over that
    vector's largest magnitude."""
    err = np.abs(got - want).max(axis=-1)
    return float((err / np.maximum(np.abs(want).max(axis=-1), 1e-30)).max())


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _pool(rng, P, Hkv, ps, D, dtype=jnp.bfloat16):
    """K/V pools rounded to bf16 once (both packages read the same
    values), held as ``dtype``."""
    k = rng.standard_normal((P, Hkv, ps, D)).astype(np.float32)
    v = rng.standard_normal((P, Hkv, ps, D)).astype(np.float32)
    kb = jnp.asarray(k, jnp.bfloat16).astype(dtype)
    vb = jnp.asarray(v, jnp.bfloat16).astype(dtype)
    return kb, vb, bridge.to_tensor(np.asarray(kb)), \
        bridge.to_tensor(np.asarray(vb))


def _block_table(rng, B, n_pg, P, live_pages):
    """Distinct random pages per row; entries past a row's live pages
    name the null page 0."""
    ids = 1 + rng.permutation(P - 1)[:B * n_pg].reshape(B, n_pg)
    for b, n in enumerate(live_pages):
        ids[b, n:] = 0
    return ids.astype(np.int32)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,bias", [(1, 64, 48, False), (8, 40, 24, True),
                                        (33, 128, 96, True)])
def test_quant_matmul_plain_bitexact(out_dtype, M, K, N, bias):
    rng = np.random.default_rng(M * 1000 + K)
    x = rng.integers(-127, 128, (M, K), dtype=np.int8)
    w = rng.integers(-127, 128, (K, N), dtype=np.int8)
    xs = rng.uniform(1e-3, 1e-1, (M, 1)).astype(np.float32)
    ws = rng.uniform(1e-4, 1e-2, (1, N)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32) if bias else None
    want = jref.quant_matmul_ref(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(xs), jnp.asarray(ws),
        None if b is None else jnp.asarray(b),
        out_dtype=getattr(jnp, out_dtype))
    got = ops.quant_matmul(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(xs),
        torch.from_numpy(ws), None if b is None else torch.from_numpy(b),
        out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    assert torch.equal(got, bridge.to_tensor(np.asarray(want)))


@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("Hkv,group", [(2, 1), (2, 2)])
def test_paged_mha_decode_plain_matches_ref(window, Hkv, group):
    rng = np.random.default_rng(window + 10 * Hkv + group)
    B, D, ps, n_pg = 4, 16, 8, 5
    P = 1 + B * n_pg
    kb, vb, kt, vt = _pool(rng, P, Hkv, ps, D)
    lengths = np.array([1, 17, n_pg * ps, 8], np.int32)  # ragged, full
    bt = _block_table(rng, B, n_pg, P, -(-lengths // ps))
    q = rng.standard_normal((B, Hkv * group, D)).astype(np.float32)
    want = _jpaged_mha(jnp.asarray(q), kb, vb, jnp.asarray(lengths),
                       jnp.asarray(bt), window=window)
    got = ops.paged_mha_decode(torch.from_numpy(q), kt, vt,
                               torch.from_numpy(lengths),
                               torch.from_numpy(bt), window=window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("mode", ["causal", "window", "anc", "anc_any"])
def test_paged_verify_plain_matches_ref(mode):
    """Ragged bases, a row starting mid-page, and a row parked at the end
    of its table (``base >= n_pg * ps``, output never read but finite).
    ``anc`` is a lower-triangular tree mask, ``anc_any`` a random one
    that lets queries see later chunk positions too."""
    rng = np.random.default_rng(
        {"causal": 0, "window": 1, "anc": 2, "anc_any": 3}[mode])
    B, C, Hkv, group, D, ps, n_pg = 3, 5, 2, 2, 16, 8, 4
    P = 1 + B * n_pg
    kb, vb, kt, vt = _pool(rng, P, Hkv, ps, D, jnp.float32)
    base = np.array([0, 11, n_pg * ps], np.int32)
    bt = _block_table(rng, B, n_pg, P, [1, 2, n_pg])
    q = rng.standard_normal((B, C, Hkv * group, D)).astype(np.float32)
    window = 4 if mode == "window" else 0
    anc = None
    if mode == "anc":
        anc = np.tril(rng.integers(0, 2, (B, C, C))).astype(np.int32)
        anc[:, np.arange(C), np.arange(C)] = 1
    elif mode == "anc_any":
        anc = rng.integers(0, 2, (B, C, C)).astype(np.int32)
    want = _jpaged_verify(
        jnp.asarray(q), kb, vb, jnp.asarray(base), jnp.asarray(bt),
        window=window, anc=None if anc is None else jnp.asarray(anc))
    got = ops.paged_verify(
        torch.from_numpy(q), kt, vt, torch.from_numpy(base),
        torch.from_numpy(bt), window=window,
        anc=None if anc is None else torch.from_numpy(anc))
    assert got.shape == q.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("window", [0, 6])
def test_paged_verify_bf16_pages_single_position_matches_decode_ref(window):
    """With bf16 pages the plain verify rounds the probabilities to bf16
    before the PV product, as the JAX oracles do: one query position at
    ``base`` is the decode oracle at length ``base + 1``."""
    rng = np.random.default_rng(40 + window)
    B, Hkv, group, D, ps, n_pg = 3, 2, 2, 16, 8, 4
    P = 1 + B * n_pg
    kb, vb, kt, vt = _pool(rng, P, Hkv, ps, D)
    base = np.array([0, 13, n_pg * ps - 1], np.int32)
    bt = _block_table(rng, B, n_pg, P, -(-(base + 1) // ps))
    q = rng.standard_normal((B, 1, Hkv * group, D)).astype(np.float32)
    want = _jpaged_mha(jnp.asarray(q[:, 0]), kb, vb, jnp.asarray(base + 1),
                       jnp.asarray(bt), window=window)
    got = ops.paged_verify(torch.from_numpy(q), kt, vt,
                           torch.from_numpy(base), torch.from_numpy(bt),
                           window=window)
    np.testing.assert_allclose(_np(got[:, 0]), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("tri", [True, False])
def test_paged_verify_tree_plain_matches_interpret_kernel(tri):
    """The plain tree-masked verify on bf16 pages against the Pallas tree
    kernel (``_paged_verify_tree_kernel``) in interpret mode, on tree
    masks and on a random mask, with a row parked past its table."""
    rng = np.random.default_rng(20 + tri)
    B, C, Hkv, group, D, ps, n_pg = 3, 6, 2, 2, 16, 8, 4
    P = 1 + B * n_pg
    kb, vb, kt, vt = _pool(rng, P, Hkv, ps, D)
    base = np.array([0, 13, n_pg * ps], np.int32)
    bt = _block_table(rng, B, n_pg, P, [1, 3, n_pg])
    q = rng.standard_normal((B, C, Hkv * group, D)).astype(np.float32)
    if tri:
        anc = np.zeros((B, C, C), np.int32)
        for b in range(B):
            anc[b, 0, 0] = 1
            for j in range(1, C):
                anc[b, j] = anc[b, rng.integers(0, j)]
                anc[b, j, j] = 1
    else:
        anc = rng.integers(0, 2, (B, C, C)).astype(np.int32)
    want = jops.paged_verify(jnp.asarray(q), kb, vb, jnp.asarray(base),
                             jnp.asarray(bt), anc=jnp.asarray(anc),
                             backend="interpret")
    got = ops.paged_verify(torch.from_numpy(q), kt, vt,
                           torch.from_numpy(base), torch.from_numpy(bt),
                           anc=torch.from_numpy(anc))
    assert _vec_rel_err(_np(got)[:2], np.asarray(want)[:2]) <= VEC_REL_TOL


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("Hkv,group,S", [(2, 1, 24), (2, 2, 37)])
@pytest.mark.parametrize("cache", ["float32", "bfloat16"])
def test_mha_decode_plain_matches_ref_and_interpret_kernel(window, Hkv,
                                                           group, S, cache):
    """The contiguous decode attention (the draft model's) against the
    JAX oracle and the Pallas ``_mha_kernel`` in interpret mode (which
    pads S to its block; the port masks a ragged S itself), on rows of
    one key to the whole cache."""
    rng = np.random.default_rng(window + S + group)
    B, D = 3, 16
    dt = getattr(jnp, cache)
    k = jnp.asarray(rng.standard_normal((B, Hkv, S, D)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((B, Hkv, S, D)), jnp.bfloat16)
    k, v = k.astype(dt), v.astype(dt)
    lengths = np.array([1, 9, S], np.int32)
    q = rng.standard_normal((B, Hkv * group, D)).astype(np.float32)
    args = (jnp.asarray(q), k, v, jnp.asarray(lengths))
    got = ops.mha_decode(torch.from_numpy(q),
                         bridge.to_tensor(np.asarray(k)),
                         bridge.to_tensor(np.asarray(v)),
                         torch.from_numpy(lengths), window=window)
    assert got.dtype == torch.float32 and got.shape == q.shape
    want = jref.mha_decode_ref(*args, window=window)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    kern = jops.mha_decode(*args, window=window, backend="interpret", bs=16)
    assert _vec_rel_err(_np(got), np.asarray(kern)) <= VEC_REL_TOL


def test_paged_verify_window_and_anc_are_exclusive():
    q = torch.zeros((1, 2, 1, 4))
    pages = torch.zeros((2, 1, 4, 4), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ops.paged_verify(q, pages, pages, torch.zeros(1, dtype=torch.int32),
                         torch.zeros((1, 1), dtype=torch.int32), window=2,
                         anc=torch.ones((1, 2, 2), dtype=torch.int32))


class _Elsewhere(torch.Tensor):
    """A tensor with no data on a device this package does not serve."""

    @staticmethod
    def __new__(cls, shape, dtype):
        return torch.Tensor._make_wrapper_subclass(
            cls, shape, dtype=dtype, device=torch.device("xpu"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError("a device this package does not serve")


def test_wrappers_refuse_devices_they_cannot_serve():
    """No silent fallback: a tensor neither on the CPU, nor on a card,
    nor on ``meta`` (the dry run's, shapes only), or operands on two
    devices, raise instead of taking the plain path."""
    args = (_Elsewhere((2, 4), torch.int8), _Elsewhere((4, 3), torch.int8),
            _Elsewhere((2, 1), torch.float32),
            _Elsewhere((1, 3), torch.float32))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.quant_matmul(*args)
    w = torch.zeros((4, 3), dtype=torch.int8, device="meta")
    s = torch.zeros((2, 1), device="meta")
    ws = torch.zeros((1, 3), device="meta")
    with pytest.raises(ValueError, match="several devices"):
        ops.quant_matmul(torch.zeros((2, 4), dtype=torch.int8), w, s, ws)


def test_plain_path_counts_no_launch():
    ops.reset_launch_counts()
    x = torch.ones((2, 4), dtype=torch.int8)
    ops.quant_matmul(x, torch.ones((4, 3), dtype=torch.int8),
                     torch.ones((2, 1)), torch.ones((1, 3)))
    ops.ln_res(torch.ones((2, 4)), torch.ones((2, 4)), torch.ones(4))
    assert ops.launch_counts() == {
        "mp_matmul": 0, "paged_mha_decode": 0, "paged_verify": 0,
        "paged_verify_tree": 0, "mha_decode": 0, "ln_res": 0}


def test_gpt2_attention_geometry_fits_shared_memory():
    """The launch geometry the wrappers pick for GPT-2 345M (16 heads of
    64, pages of 16) fits the H100's shared memory, a decode tick of 8
    rows splits each row's 64 pages into 5 runs (640 blocks), as the
    draft's contiguous float32 cache of 1,024 positions splits into 5 runs
    of 208 keys, and a prefill chunk of 32 splits into two query slices
    per KV head."""
    mha = ops._mha_geometry(8, 16, 16, 1024, 64, 4)
    assert (mha.hg, mha.kps, mha.splits) == (1, 208, 5)
    assert mha.smem <= ops._SMEM_LIMIT
    dec = ops._decode_geometry(8, 16, 16, 16, 64, 64)
    assert (dec.hg, dec.pps, dec.splits) == (1, 13, 5)
    assert dec.smem <= ops._SMEM_LIMIT
    geo = ops._verify_geometry(1, 32, 16, 16, 16, 64, 64)
    assert (geo.nq, geo.q_tiles) == (16, 2) and geo.smem <= ops._SMEM_LIMIT


#: (B, C, H, Hkv, ps, D, n_pg): GPT-2 345M's prefill chunk, chain and tree
#: verifies, GQA, small and odd pages, a long chunk, a tiny table
_VERIFY_SHAPES = [
    (1, 32, 16, 16, 16, 64, 64), (8, 5, 16, 16, 16, 64, 64),
    (8, 9, 16, 16, 16, 64, 64), (3, 33, 8, 4, 16, 64, 6),
    (5, 9, 16, 2, 8, 128, 40), (2, 17, 4, 1, 4, 16, 100),
    (4, 5, 6, 2, 24, 16, 7), (64, 1, 16, 16, 16, 64, 64),
    (1, 256, 32, 4, 32, 128, 8), (2, 3, 2, 2, 1, 16, 50),
    (8, 5, 16, 16, 16, 256, 64), (1, 32, 24, 8, 16, 128, 64)]


@pytest.mark.parametrize("shape", _VERIFY_SHAPES)
def test_verify_splits_cover_the_table_once(shape):
    """The key splits are runs of whole pages that tile ``[0, n_pg)``
    exactly once (no split empty, none past the table), each starting on
    a 16-key tile and giving every warp of a block at least one tile;
    the query tiles cover the chunk with one m16 MMA tile of rows each."""
    B, C, H, Hkv, ps, D, n_pg = shape
    geo = ops._verify_geometry(*shape)
    owner = np.zeros(n_pg, np.int64)
    for s in range(geo.splits):
        lo, hi = s * geo.pps, min((s + 1) * geo.pps, n_pg)
        assert lo < hi
        owner[lo:hi] += 1
    assert (owner == 1).all()
    assert (geo.pps * ps) % ops._VERIFY_TILE == 0
    assert geo.pps * ps >= ops._VERIFY_WARPS * ops._VERIFY_TILE
    group = H // Hkv
    assert geo.nq * group <= ops._VERIFY_ROWS
    assert (geo.q_tiles - 1) * geo.nq < C <= geo.q_tiles * geo.nq
    # as many splits as the card wants, unless the table runs out first
    blocks = B * Hkv * geo.q_tiles * geo.splits
    least = -(-ops._VERIFY_WARPS * ops._VERIFY_TILE // ps)
    assert blocks >= min(ops._VERIFY_BLOCKS,
                         B * Hkv * geo.q_tiles * (n_pg // least))


@pytest.mark.parametrize("shape", _VERIFY_SHAPES)
def test_verify_scratch_is_what_the_kernel_indexes(shape):
    """``scratch`` holds exactly the partials the kernel writes: part_o
    (splits, B, C, H, D) then part_ml (splits, B, C, H, 2), indexed as in
    ``verify_attn.cuh``: the last element of each ends the buffer."""
    B, C, H, Hkv, ps, D, n_pg = shape
    geo = ops._verify_geometry(*shape)
    BCH = B * C * H
    last_v = BCH - 1  # ((b * C + c) * H + h) at b, c, h = B-1, C-1, H-1
    assert ((B - 1) * C + C - 1) * H + H - 1 == last_v
    last_o = ((geo.splits - 1) * BCH + last_v) * D + D - 1
    ml_at = geo.splits * BCH * D
    last_ml = ml_at + 2 * ((geo.splits - 1) * BCH + last_v) + 1
    assert last_o + 1 == ml_at and last_ml + 1 == geo.scratch


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("group", [1, 2, 3, 4, 8])
def test_verify_shared_memory_fits_the_h100(D, group):
    """Rings, merge buffers and the tree's bit words stay within the
    232,448 bytes one block may use, for chunks up to 2,048 positions and
    every page size."""
    for C in (1, 5, 9, 32, 33, 512, 2048):
        for ps in (1, 8, 16, 32):
            geo = ops._verify_geometry(8, C, 4 * group, 4, ps, D, 64)
            assert geo.smem <= 232_448


def test_verify_entries_share_geometry_and_count_one_launch(monkeypatch):
    """Both entries get the geometry of the shapes alone (the bases and
    the mask do not enter it), a scratch buffer of its size, and count one
    launch per call, the causal and the tree calls apart.  The library is
    replaced by a recorder and the card by the CPU, so this runs here."""
    calls = []

    class Lib:
        def paged_verify(self, *a):
            calls.append(("causal", a))
            return 0

        def paged_verify_tree(self, *a):
            calls.append(("tree", a))
            return 0

    sizes = []
    real_empty = torch.empty

    def empty(*a, **kw):
        t = real_empty(*a, **kw)
        sizes.append(t.numel())
        return t

    monkeypatch.setattr(ops, "_route", lambda *a: True)
    monkeypatch.setattr(ops, "_stream", lambda t: 0)
    monkeypatch.setattr(ops.build, "library", lambda: Lib())
    monkeypatch.setattr(ops.torch, "empty", empty)
    B, C, H, Hkv, D, ps, n_pg = 2, 9, 8, 4, 64, 16, 12
    q = torch.zeros((B, C, H, D))
    pages = torch.zeros((1 + B * n_pg, Hkv, ps, D), dtype=torch.bfloat16)
    bt = torch.zeros((B, n_pg), dtype=torch.int32)
    anc = torch.ones((B, C, C), dtype=torch.int32)
    ops.reset_launch_counts()
    for base in ([0, 100], [50, 3]):
        b = torch.tensor(base, dtype=torch.int32)
        ops.paged_verify(q, pages, pages, b, bt)
        ops.paged_verify(q, pages, pages, b, bt, anc=anc)
    geo = ops._verify_geometry(B, C, H, Hkv, ps, D, n_pg)
    assert [k for k, _ in calls] == ["causal", "tree"] * 2
    for kind, a in calls:
        assert a[-4:-1] == (geo.nq, geo.pps, geo.splits)
        shape = a[-13:-5] if kind == "causal" else a[-12:-4]
        assert shape == (0, B, C, H, Hkv, ps, D, n_pg)
    assert sizes.count(geo.scratch) == 4
    assert ops.launch_counts()["paged_verify"] == 2
    assert ops.launch_counts()["paged_verify_tree"] == 2


def test_verify_refuses_what_the_kernel_does_not_take(monkeypatch):
    """A head dim the kernel is not built for, a group wider than one MMA
    tile of query rows, and misaligned pages raise before any launch."""
    monkeypatch.setattr(ops, "_route", lambda *a: True)
    monkeypatch.setattr(ops.build, "library", lambda: pytest.fail(
        "launched a kernel it should have refused"))
    bt = torch.zeros((1, 2), dtype=torch.int32)
    base = torch.zeros(1, dtype=torch.int32)

    def call(H, Hkv, D, offset=0):
        pool = torch.zeros(3 * Hkv * 16 * D + offset, dtype=torch.bfloat16)
        pages = pool[offset:].view(3, Hkv, 16, D)
        ops.paged_verify(torch.zeros((1, 4, H, D)), pages, pages, base, bt)

    with pytest.raises(ValueError, match="head_dim 48"):
        call(2, 2, 48)
    with pytest.raises(ValueError, match="group 32"):
        call(32, 1, 16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        call(2, 2, 64, offset=4)


#: (K, N) of GPT-2 345M's linears and a ragged one
_MP_KN = [(1024, 1024), (1024, 4096), (4096, 1024), (1000, 300)]


@pytest.mark.parametrize("K,N", _MP_KN)
@pytest.mark.parametrize("M", [1, 5, 8, 9, 16, 17, 32, 33, 40, 72, 512])
def test_mp_split_geometry_fills_the_card(M, K, N):
    """The K splits of a cluster cover every 32-row K tile exactly once,
    split as ``mp_matmul.cu`` splits them; the cluster is a power of two
    of at most 8 blocks, and as large as the card wants (about two blocks
    per SM) unless the K tiles or the cluster limit run out first; the
    token block holds M or is 64 rows; shared memory fits the H100."""
    geo = ops._mp_geometry(M, N, K)
    k_tiles = -(-K // ops._MP_KT)
    s = geo.splits
    assert s & (s - 1) == 0 and 1 <= s <= min(ops._MP_MAX_SPLITS, k_tiles)
    tps = -(-k_tiles // s)
    owner = np.zeros(k_tiles, np.int64)
    for rank in range(s):
        lo = min(k_tiles, rank * tps)
        owner[lo:min(k_tiles, lo + tps)] += 1
    assert (owner == 1).all()
    assert geo.bm in (8, 16, 32, 64) and (geo.bm >= M or geo.bm == 64)
    assert geo.bm == 8 or geo.bm // 2 < M
    assert (geo.m_blocks - 1) * geo.bm < M <= geo.m_blocks * geo.bm
    assert (geo.strips - 1) * ops._MP_BN < N <= geo.strips * ops._MP_BN
    base = geo.strips * geo.m_blocks
    most = 1 << (min(ops._MP_MAX_SPLITS, k_tiles).bit_length() - 1)
    assert s == most or 2 * s * base > ops._MP_BLOCKS
    assert s * base >= min(ops._MP_BLOCKS // 2, most * base)
    # the warps' int32 tiles, the cluster's partials and the scales fit
    tiles = ops._MP_WARPS * geo.bm * ops._MP_BN * 4
    assert geo.smem >= tiles + geo.bm * ops._MP_BN * 4 + 4 * (
        geo.bm + 2 * ops._MP_BN)
    assert geo.smem <= ops._SMEM_LIMIT


def test_mp_matmul_launches_once_without_workspace(monkeypatch):
    """The wrapper passes the geometry's cluster size, allocates only the
    output (the splits meet in distributed shared memory, not in a global
    workspace) and counts one launch per call.  The library is replaced by
    a recorder and the card by the CPU, so this runs here."""
    calls, sizes = [], []

    class Lib:
        def mp_matmul(self, *a):
            calls.append(a)
            return 0

    real_empty = torch.empty

    def empty(*a, **kw):
        t = real_empty(*a, **kw)
        sizes.append(tuple(t.shape))
        return t

    monkeypatch.setattr(ops, "_route", lambda *a: True)
    monkeypatch.setattr(ops, "_stream", lambda t: 0)
    monkeypatch.setattr(ops.build, "library", lambda: Lib())
    monkeypatch.setattr(ops.torch, "empty", empty)
    ops.reset_launch_counts()
    for M, K, N in ((8, 1024, 4096), (40, 4096, 1024)):
        ops.quant_matmul(torch.zeros((M, K), dtype=torch.int8),
                         torch.zeros((K, N), dtype=torch.int8),
                         torch.ones((M, 1)), torch.ones((1, N)),
                         torch.zeros(N), out_dtype=torch.float32)
        geo = ops._mp_geometry(M, N, K)
        assert calls[-1][6:11] == (M, N, K, geo.splits, 0)
        assert sizes == [(M, N)]
        sizes.clear()
    assert ops.launch_counts()["mp_matmul"] == 2


def test_mp_matmul_refuses_what_the_kernel_does_not_take(monkeypatch):
    """Wrong dtypes, shapes, scales and an empty operand raise before any
    launch."""
    monkeypatch.setattr(ops, "_route", lambda *a: True)
    monkeypatch.setattr(ops.build, "library", lambda: pytest.fail(
        "launched a kernel it should have refused"))
    x = torch.zeros((4, 16), dtype=torch.int8)
    w = torch.zeros((16, 8), dtype=torch.int8)
    xs, ws = torch.ones((4, 1)), torch.ones((1, 8))
    with pytest.raises(ValueError, match="must be int8"):
        ops.quant_matmul(x.float(), w, xs, ws)
    with pytest.raises(ValueError, match="shapes"):
        ops.quant_matmul(x, w[:8], xs, ws)
    with pytest.raises(ValueError, match="x_scale"):
        ops.quant_matmul(x, w, xs[:2], ws)
    with pytest.raises(ValueError, match="bias"):
        ops.quant_matmul(x, w, xs, ws, torch.zeros(7))
    with pytest.raises(ValueError, match="out_dtype"):
        ops.quant_matmul(x, w, xs, ws, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="empty"):
        ops.quant_matmul(x[:0], w, xs[:0], ws)


#: (B, H, Hkv, ps, D, n_pg): GPT-2 345M's decode tick, one row, GQA,
#: odd and one-position pages, head dims 16 and 128, a tiny table
_DECODE_SHAPES = [
    (8, 16, 16, 16, 64, 64), (1, 16, 16, 16, 64, 64), (4, 8, 2, 16, 64, 9),
    (5, 16, 2, 8, 128, 40), (2, 4, 1, 24, 16, 7), (3, 64, 1, 16, 16, 20),
    (64, 16, 16, 16, 64, 64), (2, 6, 2, 1, 64, 300), (7, 32, 4, 5, 128, 13),
    (8, 16, 16, 16, 256, 64)]


@pytest.mark.parametrize("shape", _DECODE_SHAPES)
def test_decode_splits_cover_the_table_once(shape):
    """The key splits are runs of whole pages that tile ``[0, n_pg)``
    exactly once, each giving every warp at least one 16-key tile; the
    head chunks cover the group; and, clipped as ``decode_attn.cuh``
    clips them, the splits cover each row's visible keys once, for every
    length from 0 to ``n_pg * ps`` and with a window."""
    B, H, Hkv, ps, D, n_pg = shape
    geo = ops._decode_geometry(*shape)
    owner = np.zeros(n_pg, np.int64)
    for s in range(geo.splits):
        lo, hi = s * geo.pps, min((s + 1) * geo.pps, n_pg)
        assert lo < hi
        owner[lo:hi] += 1
    assert (owner == 1).all()
    assert geo.pps * ps >= ops._DECODE_WARPS * ops._DECODE_TILE
    group = H // Hkv
    assert geo.hg in (1, 2, 4, 8)
    assert (geo.h_chunks - 1) * geo.hg < group <= geo.h_chunks * geo.hg
    assert geo.scratch == geo.splits * B * H * (D + 2)
    S = n_pg * ps
    for length in sorted({0, 1, ps - 1, ps, geo.pps * ps - 1, geo.pps * ps,
                          geo.pps * ps + 1, S - 1, S}):
        for window in (0, 1, ps + 3):
            key_lo = max(0, length - window) if window else 0
            seen = np.zeros(S, np.int64)
            for s in range(geo.splits):
                lo = max(s * geo.pps * ps, key_lo)
                hi = min((s + 1) * geo.pps * ps, min(length, S))
                seen[lo:max(lo, hi)] += 1
            want = np.zeros(S, np.int64)
            want[key_lo:min(length, S)] = 1
            assert (seen == want).all(), (length, window)
    # as many blocks as the card wants, unless the table runs out first
    blocks = B * Hkv * geo.h_chunks * geo.splits
    least = -(-ops._DECODE_WARPS * ops._DECODE_TILE // ps)
    assert blocks >= min(ops._DECODE_BLOCKS,
                         B * Hkv * geo.h_chunks * max(1, n_pg // least))


@pytest.mark.parametrize("D", [16, 64, 128, 256])
@pytest.mark.parametrize("group", range(1, 9))
def test_decode_shared_memory_fits_the_h100(D, group):
    """Rings and merge buffers stay within the 232,448 bytes one block may
    use, for every page size."""
    for ps in (1, 8, 16, 32):
        geo = ops._decode_geometry(8, 2 * group, 2, ps, D, 64)
        assert geo.smem <= 232_448


def test_decode_entry_geometry_and_count_one_launch(monkeypatch):
    """The decode wrapper passes the geometry of the shapes alone (the
    lengths do not enter it), a scratch buffer of its size, and counts one
    launch per call.  The library is replaced by a recorder."""
    calls, sizes = [], []

    class Lib:
        def paged_mha_decode(self, *a):
            calls.append(a)
            return 0

    real_empty = torch.empty

    def empty(*a, **kw):
        t = real_empty(*a, **kw)
        sizes.append(t.numel())
        return t

    monkeypatch.setattr(ops, "_route", lambda *a: True)
    monkeypatch.setattr(ops, "_stream", lambda t: 0)
    monkeypatch.setattr(ops.build, "library", lambda: Lib())
    monkeypatch.setattr(ops.torch, "empty", empty)
    B, H, Hkv, D, ps, n_pg = 3, 8, 2, 64, 16, 12
    q = torch.zeros((B, H, D), dtype=torch.bfloat16)
    pages = torch.zeros((1 + B * n_pg, Hkv, ps, D), dtype=torch.bfloat16)
    bt = torch.zeros((B, n_pg), dtype=torch.int32)
    ops.reset_launch_counts()
    for lengths in ([0, 5, 192], [100, 1, 3]):
        ops.paged_mha_decode(q, pages, pages,
                             torch.tensor(lengths, dtype=torch.int32), bt,
                             window=7)
    geo = ops._decode_geometry(B, H, Hkv, ps, D, n_pg)
    for a in calls:
        assert a[7:] == (1, B, H, Hkv, ps, D, n_pg, 7, geo.hg, geo.pps,
                         geo.splits, 0)
    assert sizes.count(geo.scratch) == 2
    assert ops.launch_counts()["paged_mha_decode"] == 2


def test_decode_refuses_what_the_kernel_does_not_take(monkeypatch):
    """A head dim the kernel is not built for (48, and 512, past the widest
    built, 256), misaligned pages and an empty table raise before any
    launch."""
    monkeypatch.setattr(ops, "_route", lambda *a: True)
    monkeypatch.setattr(ops.build, "library", lambda: pytest.fail(
        "launched a kernel it should have refused"))
    lengths = torch.ones(1, dtype=torch.int32)

    def call(H, Hkv, D, offset=0, n_pg=2):
        pool = torch.zeros(3 * Hkv * 16 * D + offset, dtype=torch.bfloat16)
        pages = pool[offset:].view(3, Hkv, 16, D)
        ops.paged_mha_decode(torch.zeros((1, H, D)), pages, pages, lengths,
                             torch.zeros((1, n_pg), dtype=torch.int32))

    with pytest.raises(ValueError, match="head_dim 48"):
        call(2, 2, 48)
    with pytest.raises(ValueError, match="head_dim 512"):
        call(2, 2, 512)
    with pytest.raises(ValueError, match="16-byte aligned"):
        call(2, 2, 64, offset=4)
    with pytest.raises(ValueError, match="empty"):
        call(2, 2, 64, n_pg=0)


#: (B, H, Hkv, S, D, elem): the draft's float32 cache and the stacked
#: target's bf16 one at GPT-2 345M, GQA, a wide group of 16 at D 128,
#: ragged S, S below one 16-key tile and below one split, one row
_MHA_SHAPES = [
    (8, 16, 16, 1024, 64, 4), (8, 16, 16, 1024, 64, 2),
    (4, 8, 2, 100, 64, 4), (3, 16, 1, 333, 128, 4), (2, 16, 1, 77, 128, 2),
    (5, 4, 4, 7, 16, 4), (1, 16, 16, 1000, 64, 2), (64, 16, 16, 1024, 64, 4),
    (2, 6, 2, 50, 16, 2), (7, 32, 4, 129, 128, 2), (8, 16, 16, 1024, 256, 4),
    (3, 16, 1, 300, 256, 2)]


@pytest.mark.parametrize("shape", _MHA_SHAPES)
def test_mha_splits_cover_the_cache_once(shape):
    """The key splits are runs of whole 16-key tiles that tile ``[0, S)``
    exactly once, each giving every warp at least one tile (unless the
    cache is shorter); the head chunks cover the group; and, clipped as
    ``decode_attn.cuh`` clips them, the splits cover each row's visible
    keys once, for every length from 0 to past ``S`` and with a window."""
    B, H, Hkv, S, D, elem = shape
    geo = ops._mha_geometry(*shape)
    assert geo.kps % ops._DECODE_TILE == 0
    assert geo.kps >= ops._DECODE_WARPS * ops._DECODE_TILE
    owner = np.zeros(S, np.int64)
    for s in range(geo.splits):
        lo, hi = s * geo.kps, min((s + 1) * geo.kps, S)
        assert lo < hi
        owner[lo:hi] += 1
    assert (owner == 1).all()
    group = H // Hkv
    assert geo.hg in (1, 2, 4, 8)
    assert (geo.h_chunks - 1) * geo.hg < group <= geo.h_chunks * geo.hg
    for length in sorted({0, 1, 15, 16, 17, geo.kps - 1, geo.kps,
                          geo.kps + 1, S - 1, S, S + 5}):
        for window in (0, 1, 7, 128):
            key_lo = max(0, length - window) if window else 0
            seen = np.zeros(S, np.int64)
            for s in range(geo.splits):
                lo = max(s * geo.kps, key_lo)
                hi = min((s + 1) * geo.kps, min(length, S))
                seen[lo:max(lo, hi)] += 1
            want = np.zeros(S, np.int64)
            want[min(key_lo, S):min(length, S)] = 1
            assert (seen == want).all(), (length, window)
    # as many blocks as the card wants, unless the cache runs out first
    blocks = B * Hkv * geo.h_chunks * geo.splits
    assert blocks >= min(ops._DECODE_BLOCKS,
                         B * Hkv * geo.h_chunks * max(1, S // 64))


@pytest.mark.parametrize("shape", _MHA_SHAPES)
def test_mha_scratch_is_what_the_kernel_indexes(shape):
    """``split_kernel`` writes part_o[(s * B * H + b * H + h) * D + d] and
    part_ml[2 * (s * B * H + b * H + h) + {0, 1}] for every split, row and
    head; the scratch holds exactly that."""
    B, H, Hkv, S, D, elem = shape
    geo = ops._mha_geometry(*shape)
    last = (geo.splits - 1) * B * H + (B - 1) * H + (H - 1)
    part_o = (last + 1) * D
    assert geo.scratch == part_o + 2 * (last + 1)


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("D", [16, 64, 128, 256])
@pytest.mark.parametrize("group", [1, 2, 3, 4, 8, 16])
def test_mha_shared_memory_fits_the_h100(elem, D, group):
    """Rings (3 stages of 16-key K and V tiles per warp, 196,608 B at D 128
    in float32 with 4 warps, and at D 256 in float32 with 2) and the
    warps' partials of every head chunk stay within the 232,448 bytes one
    block may use."""
    geo = ops._mha_geometry(8, 2 * group, 2, 1024, D, elem)
    warps = 2 if D * elem > 128 * 4 else 4
    assert ops._decode_warps(D, elem) == warps
    assert geo.smem == max(warps * 3 * 2 * 16 * D * elem,
                           warps * geo.hg * (D + 2) * 4)
    assert geo.smem <= 232_448


def test_mha_entry_counts_one_launch_and_takes_wide_groups(monkeypatch):
    """The contiguous decode wrapper passes the geometry of the shapes
    alone (the lengths do not enter it), a scratch buffer of its size, and
    counts one launch per call; a group of 16 at D 128, beyond the old
    1,024-accumulator cap, is taken, by the paged decode too."""
    calls, sizes = [], []

    class Lib:
        def mha_decode(self, *a):
            calls.append(a)
            return 0

        def paged_mha_decode(self, *a):
            calls.append(a)
            return 0

    real_empty = torch.empty

    def empty(*a, **kw):
        t = real_empty(*a, **kw)
        sizes.append(t.numel())
        return t

    monkeypatch.setattr(ops, "_route", lambda *a: True)
    monkeypatch.setattr(ops, "_stream", lambda t: 0)
    monkeypatch.setattr(ops.build, "library", lambda: Lib())
    monkeypatch.setattr(ops.torch, "empty", empty)
    ops.reset_launch_counts()
    for B, H, Hkv, S, D, kv in ((3, 8, 2, 100, 64, torch.float32),
                                (2, 16, 1, 77, 128, torch.bfloat16)):
        q = torch.zeros((B, H, D), dtype=torch.bfloat16)
        k = torch.zeros((B, Hkv, S, D), dtype=kv)
        calls.clear()
        sizes.clear()
        for lengths in ([0, 5, S][:B], [S + 3, 1, 2][:B]):
            ops.mha_decode(q, k, k, torch.tensor(lengths, dtype=torch.int32),
                           window=7)
        geo = ops._mha_geometry(B, H, Hkv, S, D, k.element_size())
        for a in calls:
            assert len(a) == len(build.SIGNATURES["mha_decode"])
            assert a[6:] == (1, int(kv == torch.bfloat16), B, H, Hkv, S, D, 7,
                             geo.hg, geo.kps, geo.splits, 0)
        assert sizes.count(geo.scratch) == 2
    assert ops.launch_counts()["mha_decode"] == 4
    pages = torch.zeros((5, 1, 16, 128), dtype=torch.bfloat16)
    ops.paged_mha_decode(torch.zeros((2, 16, 128)), pages, pages,
                         torch.ones(2, dtype=torch.int32),
                         torch.zeros((2, 2), dtype=torch.int32))
    assert calls[-1][12:14] == (128, 2)  # D, n_pg
    assert ops.launch_counts()["paged_mha_decode"] == 1


def test_mha_refuses_what_the_kernel_does_not_take(monkeypatch):
    """Head dims the decode body is not built for (32, and 512, past the
    widest built, 256) are refused by name, as are a misaligned cache and
    an empty one, before any launch."""
    monkeypatch.setattr(ops, "_route", lambda *a: True)
    monkeypatch.setattr(ops.build, "library", lambda: pytest.fail(
        "launched a kernel it should have refused"))
    lengths = torch.ones(2, dtype=torch.int32)

    def call(D, S=8, offset=0):
        pool = torch.zeros(2 * 2 * S * D + offset, dtype=torch.float32)
        k = pool[offset:].view(2, 2, S, D)
        ops.mha_decode(torch.zeros((2, 4, D)), k, k, lengths)

    for D in (32, 512):
        with pytest.raises(ValueError, match=f"head_dim {D} not one of"):
            call(D)
    with pytest.raises(ValueError, match="16-byte aligned"):
        call(64, offset=1)
    with pytest.raises(ValueError, match="empty"):
        call(64, S=0)


@pytest.mark.parametrize("D,nv", [
    (16, 1), (200, 1), (256, 1), (257, 1), (1000, 1), (1024, 1), (2048, 1),
    (2049, 2), (4096, 2), (8192, 4), (8193, 8), (16384, 8)])
def test_ln_res_chunks_cover_the_row(D, nv):
    """A block of 256 threads per row, each thread holding the fewest
    power-of-two count of 8-column chunks that covers the row (at most
    8, 64 values)."""
    assert ops._ln_res_chunks(D) == nv <= ops._LN_MAX_NV
    assert nv * 8 * 256 >= D
    assert nv == 1 or D > nv * 8 * 128


def test_ln_res_entry_passes_the_geometry(monkeypatch):
    """The wrapper passes the chunks per thread and 16-byte accesses only
    for a width that is a multiple of 8; it refuses a row wider than a
    block holds in registers; one launch per call."""
    calls = []

    class Lib:
        def ln_res(self, *a):
            calls.append(a)
            return 0

    monkeypatch.setattr(ops, "_route", lambda *a: True)
    monkeypatch.setattr(ops, "_stream", lambda t: 0)
    monkeypatch.setattr(ops.build, "library", lambda: Lib())
    ops.reset_launch_counts()
    shapes = ((3, 1000), (5, 257), (2, 4096), (3, 100), (33, 200))
    for B, D in shapes:
        ops.ln_res(torch.ones((B, D)), torch.ones((B, D)), torch.ones(D))
        assert len(calls[-1]) == len(build.SIGNATURES["ln_res"])
        assert calls[-1][10:12] == (B, D)
        assert calls[-1][14:16] == (ops._ln_res_chunks(D), int(D % 8 == 0))
    assert ops.launch_counts()["ln_res"] == len(shapes)
    with pytest.raises(ValueError, match="exceeds the 16384 columns"):
        ops.ln_res(torch.ones((1, 16392)), torch.ones((1, 16392)),
                   torch.ones(16392))


def test_build_without_toolkit_raises(monkeypatch, tmp_path):
    """A missing compiler is an error, never a quiet fallback."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert {p.name for p in build.sources()} == {
        "ln_res.cu", "mha_decode.cu", "mp_matmul.cu", "paged_mha.cu",
        "paged_verify.cu"}



def test_mdk_registry_names_the_reference_kernels():
    """Each macro kernel kind maps to the wrapper of the same kernel as in
    the reference (``"mha"`` to the contiguous decode attention, not its
    paged sibling), and the registry has the reference's keys."""
    from repro.core import mdk as jmdk
    from repro_torch.core import mdk

    assert set(mdk.MDK_REGISTRY) == set(jmdk.MDK_REGISTRY)
    for kind, fn in mdk.MDK_REGISTRY.items():
        assert fn.__name__ == jmdk.MDK_REGISTRY[kind].__name__
    assert mdk.MDK_REGISTRY["mha"] is ops.mha_decode
    assert mdk.MDK_REGISTRY["ln_res"] is ops.ln_res


# ---------------------------------------------------------------------------
# ln_res


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values around float32 ``a`` (8 significand
    bits); subnormal magnitudes take the smallest normal's spacing."""
    mag = np.maximum(np.abs(a), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


def assert_ln_res_close(got, want):
    """``got`` (the port's torch outputs) against ``want`` (the JAX
    package's) under the tolerances of the module docstring."""
    y, r, yq, sc = (np.asarray(jnp.asarray(w).astype(jnp.float32))
                    if w.dtype != jnp.int8 else np.asarray(w) for w in want)
    gy, gr = got[0].float().numpy(), got[1].float().numpy()
    gq, gs = got[2].numpy(), got[3].numpy()
    assert got[0].dtype == torch.bfloat16 and got[2].dtype == torch.int8
    assert gs.shape == sc.shape and gy.shape == y.shape
    np.testing.assert_array_equal(gr, r)
    np.testing.assert_allclose(gs, sc, rtol=1e-5, atol=0)
    assert (np.abs(gy - y) <= np.maximum(_bf16_ulp(y), _bf16_ulp(gy))).all()
    dq = np.abs(gq.astype(np.int32) - yq.astype(np.int32))
    assert dq.max() <= 1 and (dq == 0).mean() >= 0.999


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
@pytest.mark.parametrize("B,D,bias", [(8, 1024, True), (3, 1000, True),
                                      (33, 257, False), (1, 64, True)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_res_plain_matches_ref_and_interpret_kernel(kind, B, D, bias,
                                                        dtype):
    """The plain version against ``ref.ln_res_ref`` and against the
    Pallas kernel (``_ln_res_kernel``) in interpret mode, as the JAX
    package's own kernel tests run it; rows with a large mean too."""
    rng = np.random.default_rng(B * D + len(kind) + len(dtype))
    x = rng.standard_normal((B, D)).astype(np.float32) * 3
    res = (rng.standard_normal((B, D)) + rng.uniform(-50, 50, (B, 1))
           ).astype(np.float32)
    w = rng.uniform(0.5, 1.5, D).astype(np.float32)
    b = (0.1 * rng.standard_normal(D)).astype(np.float32) if bias else None
    jx, jr = (jnp.asarray(a).astype(dtype) for a in (x, res))
    jb = None if b is None else jnp.asarray(b)
    tx, tr = (bridge.to_tensor(np.asarray(a)) for a in (jx, jr))
    got = ops.ln_res(tx, tr, torch.from_numpy(w),
                     None if b is None else torch.from_numpy(b), kind=kind)
    assert got[1].dtype == tr.dtype
    assert_ln_res_close(got, jref.ln_res_ref(jx, jr, jnp.asarray(w), jb,
                                             kind=kind))
    assert_ln_res_close(got, jops.ln_res(jx, jr, jnp.asarray(w), jb,
                                         kind=kind, backend="interpret"))


def test_ln_res_refuses_an_unknown_norm():
    with pytest.raises(ValueError, match="unknown norm kind"):
        ops.ln_res(torch.ones((1, 4)), torch.ones((1, 4)), torch.ones(4),
                   kind="batchnorm")
