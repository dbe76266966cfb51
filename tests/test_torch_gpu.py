"""The port's CUDA kernels against their plain PyTorch versions on an
NVIDIA H100, and the W8A8 engine on the card.  Every test here needs the
card (marker ``gpu``) and skips without one; the file imports no JAX, so
it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerances: the W8A8 kernel is bit-identical to its plain version (exact
int32 sums, the same float32 epilogue order).  The attention kernels keep
the softmax probabilities in float32 where the plain versions round them
to bf16 before the PV product, as the JAX reference does, so each output
vector (one row, query and head) agrees to ``1e-2`` of that vector's
largest magnitude.  The normalisation is per vector because the vectors'
scales differ: a row with one key returns a value row of the cache (order
1), a row with a thousand keys an average of them (order 0.05), and a
fault on the long row, such as a page left out, must not hide under the
short row's scale.  The split-KV verify is also held bit for bit against
itself: a second call on the same inputs (its splits merge in a fixed
order), and a lower-triangular tree mask against the causal mask.
``quant_act`` is bit-identical to its plain version run on the CPU
(IEEE divisions, a maximum in any order).  ``ln_res`` keeps the new
residual bit-identical,
``scale`` within 1e-5 relative, ``y`` within one bf16 ulp per element and
``y_q`` within 1 everywhere and equal on at least 99.9% of elements (the
kernel takes its sums in another order than the plain version).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.serving import near_tie
from torch_helpers import ForcedDrafts

ATTN_REL_TOL = 1e-2


@pytest.fixture
def h100():
    """The card, decided when a test runs, never when the module is
    imported, so that every test worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA H100; no CUDA device is visible")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        pytest.skip(f"needs compute capability (9, 0), found {cap}")
    return torch.device("cuda", 0)


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest error of an output vector (the last axis) over that
    vector's largest magnitude."""
    err = (got.float() - want.float()).abs().amax(dim=-1)
    return (err / want.float().abs().amax(dim=-1).clamp_min(1e-30)).max(
    ).item()


def _pool(rng, P, Hkv, ps, D, dev):
    k = torch.from_numpy(rng.standard_normal((P, Hkv, ps, D)).astype(
        np.float32)).to(device=dev, dtype=torch.bfloat16)
    v = torch.from_numpy(rng.standard_normal((P, Hkv, ps, D)).astype(
        np.float32)).to(device=dev, dtype=torch.bfloat16)
    return k, v


def _block_table(rng, B, n_pg, P, live_pages, dev):
    """Distinct random pages per row; entries past a row's live pages
    name the null page 0."""
    ids = 1 + rng.permutation(P - 1)[:B * n_pg].reshape(B, n_pg)
    for b, n in enumerate(live_pages):
        ids[b, n:] = 0
    return torch.from_numpy(ids.astype(np.int32)).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N,bias", [
    (1, 1024, 1024, False), (8, 4096, 1024, True), (32, 1024, 4096, False),
    (5, 1000, 300, True), (512, 1024, 4096, True), (3, 7, 5, False)])
def test_mp_matmul_kernel_bitexact_on_card(h100, out_dtype, M, K, N, bias):
    """Decode, prefill and large-M shapes (many K slices and one), and
    ragged ones that take the byte-load edges."""
    rng = np.random.default_rng(M + K + N)
    x = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8))
    xs = torch.from_numpy(rng.uniform(1e-3, 1e-1, (M, 1)).astype(np.float32))
    ws = torch.from_numpy(rng.uniform(1e-4, 1e-2, (1, N)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(N).astype(np.float32)) \
        if bias else None
    args = [t if t is None else t.to(h100) for t in (x, w, xs, ws, b)]
    dt = getattr(torch, out_dtype)
    ops.reset_launch_counts()
    got = ops.quant_matmul(*args, out_dtype=dt)
    want = ref.quant_matmul_ref(*args, out_dtype=dt)
    torch.cuda.synchronize()
    assert got.device == h100 and got.dtype == dt
    assert torch.equal(got, want)
    assert ops.launch_counts()["mp_matmul"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hkv,group", [(2, 2), (16, 1)])
def test_paged_mha_decode_kernel_matches_plain_on_card(h100, window, qdtype,
                                                       Hkv, group):
    rng = np.random.default_rng(window + Hkv)
    B, D, ps, n_pg = 4, 64, 16, 9
    P = 1 + B * n_pg
    kp, vp = _pool(rng, P, Hkv, ps, D, h100)
    lengths_np = np.array([1, 37, n_pg * ps, 0], np.int32)  # last row empty
    bt = _block_table(rng, B, n_pg, P, -(-lengths_np // ps), h100)
    lengths = torch.from_numpy(lengths_np).to(h100)
    q = torch.from_numpy(rng.standard_normal((B, Hkv * group, D)).astype(
        np.float32)).to(device=h100, dtype=getattr(torch, qdtype))
    ops.reset_launch_counts()
    got = ops.paged_mha_decode(q, kp, vp, lengths, bt, window=window)
    want = ref.paged_mha_decode_ref(q, kp, vp, lengths, bt, window=window)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    assert bool((got[3] == 0).all())  # no valid key: 0, not NaN
    assert _rel_err(got[:3], want[:3]) <= ATTN_REL_TOL
    assert ops.launch_counts()["paged_mha_decode"] == 1


def _mp_case(rng, M, K, N, bias, dev):
    x = torch.from_numpy(rng.integers(-127, 128, (M, K), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8))
    xs = torch.from_numpy(rng.uniform(1e-3, 1e-1, (M, 1)).astype(np.float32))
    ws = torch.from_numpy(rng.uniform(1e-4, 1e-2, (1, N)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(N).astype(np.float32)) \
        if bias else None
    return [t if t is None else t.to(dev) for t in (x, w, xs, ws, b)]


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("K,N", [(1024, 1024), (1024, 4096), (4096, 1024),
                                 (1000, 300)])
@pytest.mark.parametrize("M", [1, 5, 8, 9, 16, 17, 32, 33, 40, 72])
def test_mp_matmul_bitexact_at_serving_widths_on_card(h100, M, K, N, bias,
                                                      out_dtype):
    """Every token count the engines send (decode 1-8, prefill chunk 32,
    chain and tree verifies 40 and 72) and the edges of each token block,
    at GPT-2 345M's three weight shapes and a ragged one (N and K not
    multiples of 16: the byte-load staging)."""
    rng = np.random.default_rng(M * 7 + K + N + bias)
    args = _mp_case(rng, M, K, N, bias, h100)
    dt = getattr(torch, out_dtype)
    got = ops.quant_matmul(*args, out_dtype=dt)
    again = ops.quant_matmul(*args, out_dtype=dt)
    want = ref.quant_matmul_ref(*args, out_dtype=dt)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_mp_matmul_is_one_cuda_launch_without_host_sync_on_card(h100):
    """One call is one CUDA function (the K splits meet inside their
    cluster, not in a second kernel), by ``torch.profiler``; and the
    wrapper never waits for the card (``set_sync_debug_mode("error")``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(3)
    cases = [_mp_case(rng, M, K, N, True, h100)
             for M, K, N in ((8, 1024, 4096), (32, 4096, 1024),
                             (72, 1024, 1024), (5, 1000, 300))]
    for args in cases:  # build, load and warm up
        ops.quant_matmul(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for args in cases:
                ops.quant_matmul(*args)
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert len(kernels) == len(cases), kernels
    assert all("mp_matmul_kernel" in k for k in kernels), kernels


def _decode_case(rng, dev, lengths_np, Hkv, group, D=64, ps=16, n_pg=24,
                 qdtype="float32"):
    """Pages, a block table live up to each row's length, lengths and a
    query for the split-KV decode cases."""
    B = len(lengths_np)
    P = 1 + B * n_pg
    kp, vp = _pool(rng, P, Hkv, ps, D, dev)
    lengths_np = np.asarray(lengths_np, np.int32)
    bt = _block_table(rng, B, n_pg, P, -(-lengths_np // ps), dev)
    q = torch.from_numpy(rng.standard_normal((B, Hkv * group, D)).astype(
        np.float32)).to(device=dev, dtype=getattr(torch, qdtype))
    return q, kp, vp, torch.from_numpy(lengths_np).to(dev), bt


def _decode_split_lengths(H, Hkv, ps, D, n_pg, B=9):
    """Lengths 0, 1 and 16, a length on each side of the first two split
    edges of the geometry at ``B`` rows, and ``n_pg * ps``."""
    geo = ops._decode_geometry(B, H, Hkv, ps, D, n_pg)
    assert geo.splits >= 3, geo
    edge = geo.pps * ps
    return [0, 1, 16, edge - 1, edge, edge + 1, 2 * edge - 1, 2 * edge + 1,
            n_pg * ps]


def _batches(values, B, pad):
    """``values`` in runs of ``B``, the last run filled up with ``pad``:
    each run one call of ``B`` rows, the row count whose split geometry
    the values were chosen at."""
    return [(list(values[i:i + B]) + [pad] * B)[:B]
            for i in range(0, len(values), B)]


#: (B, n_pg, Hkv, group, D, qdtype, window): 9 rows in a table of 40 pages
#: at every head shape, window and query type; GPT-2's heads at a serving
#: tick's 8 rows and a shard's 4 and 2 (2 x 4, 4 x 2) in its table of 64
#: pages, with the windows and query types its engines send
_PAGED_EDGE_CASES = [
    (9, 40, Hkv, group, D, qdtype, window)
    for Hkv, group, D in ((16, 1, 64), (4, 2, 64), (2, 4, 64), (4, 1, 128),
                          (2, 4, 16))
    for qdtype in ("float32", "bfloat16") for window in (0, 40)] + [
    (B, 64, 16, 1, 64, qdtype, window) for B in (8, 4, 2)
    for qdtype, window in (("float32", 0), ("float32", 128),
                           ("bfloat16", 0))]


@pytest.mark.gpu
@pytest.mark.parametrize("B,n_pg,Hkv,group,D,qdtype,window",
                         _PAGED_EDGE_CASES)
def test_paged_mha_decode_split_edges_on_card(h100, B, n_pg, Hkv, group, D,
                                              qdtype, window):
    """Rows of lengths 0, 1, 16, at key-split edges +-1 and at the end of
    the table, with and without a window that crosses a split edge; GQA
    groups 2 and 4, head dims 16, 64 and 128, q float32 and bf16; each
    call at the split edges of its own row count (the geometry follows
    B).  Each output vector within 1e-2 of its largest magnitude, an
    empty row exactly 0, two calls bit-identical."""
    rng = np.random.default_rng([window, group, D, B, n_pg])
    ps = 16
    lengths_all = _decode_split_lengths(Hkv * group, Hkv, ps, D, n_pg, B)
    runs = _batches(lengths_all, B, n_pg * ps)
    ops.reset_launch_counts()
    for lengths_np in runs:
        q, kp, vp, lengths, bt = _decode_case(rng, h100, lengths_np, Hkv,
                                              group, D, ps, n_pg, qdtype)
        got = ops.paged_mha_decode(q, kp, vp, lengths, bt, window=window)
        again = ops.paged_mha_decode(q, kp, vp, lengths, bt, window=window)
        want = ref.paged_mha_decode_ref(q, kp, vp, lengths, bt,
                                        window=window)
        torch.cuda.synchronize()
        live = lengths > 0
        assert got.dtype == q.dtype and got.shape == q.shape
        assert bool((got[~live] == 0).all())  # no valid key: 0, not NaN
        assert _rel_err(got[live], want[live]) <= ATTN_REL_TOL
        assert torch.equal(got, again)
    assert ops.launch_counts()["paged_mha_decode"] == 2 * len(runs)


@pytest.mark.gpu
def test_paged_mha_decode_odd_pages_and_wide_group_on_card(h100):
    """Pages of 24 positions (splits not on 16-key tiles) and a group of 16
    query heads per KV head (two head chunks of 8)."""
    rng = np.random.default_rng(24)
    for Hkv, group, ps in ((4, 2, 24), (1, 16, 16)):
        n_pg = 20
        lengths_np = [0, 1, 23, 24, 25, 200, 333, n_pg * ps]
        q, kp, vp, lengths, bt = _decode_case(rng, h100, lengths_np, Hkv,
                                              group, 64, ps, n_pg)
        for window in (0, 30):
            got = ops.paged_mha_decode(q, kp, vp, lengths, bt, window=window)
            want = ref.paged_mha_decode_ref(q, kp, vp, lengths, bt,
                                            window=window)
            torch.cuda.synchronize()
            assert bool((got[0] == 0).all())
            assert _rel_err(got[1:], want[1:]) <= ATTN_REL_TOL


@pytest.mark.gpu
def test_paged_mha_decode_makes_no_host_sync_on_card(h100):
    """The wrapper (geometry, scratch, both launches) never waits for the
    card: it runs under ``set_sync_debug_mode("error")``."""
    rng = np.random.default_rng(8)
    q, kp, vp, lengths, bt = _decode_case(rng, h100, [0, 40, 300], 4, 2)
    ops.paged_mha_decode(q, kp, vp, lengths, bt)  # build and load
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.paged_mha_decode(q, kp, vp, lengths, bt)
        ops.paged_mha_decode(q, kp, vp, lengths, bt, window=5)
        ops.paged_mha_decode(q.bfloat16(), kp, vp, lengths, bt)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("Hkv,group,n_pg,bases,window", [
    (4, 2, 6, (0, 45, 96), 0), (4, 2, 6, (0, 45, 96), 20),
    (16, 1, 64, (480, 1024), 0), (16, 1, 64, (480, 1024), 100)])
def test_paged_verify_kernel_matches_plain_on_card(h100, Hkv, group, n_pg,
                                                   bases, window):
    """Ragged bases, a chunk crossing pages, and a row parked past its
    table (output never read, but the kernel stays inside the table): 4
    KV heads of group 2 in a table of 6 pages, and a prefill chunk at base
    480 at GPT-2's 16 heads in its table of 64 pages."""
    rng = np.random.default_rng([window, n_pg])
    C, D, ps = 32, 64, 16
    base_np = np.array(bases, np.int32)
    B = len(base_np)
    P = 1 + B * n_pg
    kp, vp = _pool(rng, P, Hkv, ps, D, h100)
    base = torch.from_numpy(base_np).to(h100)
    bt = _block_table(rng, B, n_pg, P,
                      np.minimum(-(-(base_np + C) // ps), n_pg), h100)
    q = torch.from_numpy(rng.standard_normal(
        (B, C, Hkv * group, D)).astype(np.float32)).to(h100)
    ops.reset_launch_counts()
    got = ops.paged_verify(q, kp, vp, base, bt, window=window)
    want = ref.paged_verify_ref(q, kp, vp, base, bt, window=window)
    torch.cuda.synchronize()
    live = torch.from_numpy(base_np < n_pg * ps).to(h100)
    assert _rel_err(got[live], want[live]) <= ATTN_REL_TOL
    assert bool(torch.isfinite(got).all())
    assert ops.launch_counts()["paged_verify"] == 1
    assert ops.launch_counts()["paged_verify_tree"] == 0


def _tree_anc(rng, B, C):
    """Ancestor masks of random trees in DFS layout: node j hangs off a
    random earlier position and sees its parent's path plus itself."""
    anc = np.zeros((B, C, C), np.int32)
    for b in range(B):
        anc[b, 0, 0] = 1
        for j in range(1, C):
            anc[b, j] = anc[b, rng.integers(0, j)]
            anc[b, j, j] = 1
    return anc


@pytest.mark.gpu
@pytest.mark.parametrize("n_pg,Hkv,group,qdtype,C", [
    (6, Hkv, group, qdtype, C) for Hkv, group in ((4, 2), (16, 1))
    for qdtype in ("float32", "bfloat16") for C in (5, 9)] + [
    (64, 16, 1, qdtype, C) for qdtype in ("float32", "bfloat16")
    for C in (5, 9)])
def test_paged_verify_tree_kernel_matches_plain_on_card(h100, n_pg, Hkv,
                                                        group, qdtype, C):
    """The tree body on random trees and on a random mask that is not
    triangular at all (a query may see later chunk positions), with bases
    at and beside page edges and a row parked past its table, in a table
    of 6 pages (5 rows) and in GPT-2's of 64 (8 rows: the end of the
    table, mid rows); a lower-triangular mask is bit-identical to the
    causal kernel."""
    rng = np.random.default_rng([C, Hkv, n_pg])
    D, ps = 64, 16
    S = n_pg * ps
    base_np = np.array([0, 15, 16, 45, S] if n_pg == 6 else
                       [0, 15, 16, 31, S - C, S // 3, S // 2, S], np.int32)
    B = len(base_np)
    P = 1 + B * n_pg
    kp, vp = _pool(rng, P, Hkv, ps, D, h100)
    bt = _block_table(rng, B, n_pg, P,
                      np.minimum(-(-(base_np + C) // ps), n_pg), h100)
    base = torch.from_numpy(base_np).to(h100)
    q = torch.from_numpy(rng.standard_normal(
        (B, C, Hkv * group, D)).astype(np.float32)).to(
            device=h100, dtype=getattr(torch, qdtype))
    ops.reset_launch_counts()
    for anc_np in (_tree_anc(rng, B, C),
                   rng.integers(0, 2, (B, C, C)).astype(np.int32)):
        anc = torch.from_numpy(anc_np).to(h100)
        got = ops.paged_verify(q, kp, vp, base, bt, anc=anc)
        want = ref.paged_verify_ref(q, kp, vp, base, bt, anc=anc)
        torch.cuda.synchronize()
        assert got.dtype == q.dtype and got.shape == q.shape
        assert _rel_err(got[:-1], want[:-1]) <= ATTN_REL_TOL
        assert bool(torch.isfinite(got).all())
    tril = torch.tril(torch.ones((B, C, C), dtype=torch.int32,
                                 device=h100))
    got = ops.paged_verify(q, kp, vp, base, bt, anc=tril)
    causal = ops.paged_verify(q, kp, vp, base, bt)
    torch.cuda.synchronize()
    assert torch.equal(got, causal)
    assert ops.launch_counts()["paged_verify_tree"] == 3
    assert ops.launch_counts()["paged_verify"] == 1


def _verify_case(rng, dev, B, C, Hkv, group, base_np, qdtype="float32",
                 D=64, ps=16, n_pg=16):
    """Pages, a block table live up to each row's chunk end, bases and a
    query for the split-KV verify cases."""
    P = 1 + B * n_pg
    kp, vp = _pool(rng, P, Hkv, ps, D, dev)
    base_np = np.asarray(base_np, np.int32)
    bt = _block_table(rng, B, n_pg, P,
                      np.minimum(-(-(base_np + C) // ps), n_pg), dev)
    q = torch.from_numpy(rng.standard_normal(
        (B, C, Hkv * group, D)).astype(np.float32)).to(
            device=dev, dtype=getattr(torch, qdtype))
    return q, kp, vp, torch.from_numpy(base_np).to(dev), bt


def _split_edge_bases(C, Hkv, group, ps, n_pg, B=7):
    """Row bases whose last key falls on the last position of split 0, on
    the first of split 1 and one page past it; base 0; a row ending at
    ``n_pg * ps``; a mid row; a row parked at the end of its table."""
    geo = ops._verify_geometry(B, C, Hkv * group, Hkv, ps, 64, n_pg)
    assert geo.splits >= 3, geo
    edge = geo.pps * ps
    S = n_pg * ps
    return [edge - C, edge - C + 1, edge - C + 1 + ps, 0, S - C,
            (S - C) // 2, S]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hkv,n_pg,C,qdtype,tree", [
    (7, 4, 24, C, qdtype, tree) for C in (5, 32)
    for qdtype in ("float32", "bfloat16") for tree in (False, True)] + [
    (B, 16, 64, C, qdtype, tree) for B in (8, 4, 2) for C in (5, 9, 32)
    for qdtype in ("float32", "bfloat16") for tree in (False, True)])
def test_paged_verify_split_edges_on_card(h100, B, Hkv, n_pg, C, qdtype,
                                          tree):
    """Rows whose keys end exactly on a split edge, just past it, a page
    past it and on the second edge, at base 0, at the end of the table and
    parked: each split is merged once.  Calls of 7 rows of 4 KV heads in a
    table of 24 pages, and of 8, 4 and 2 rows (a serving tick's, a
    shard's of 2 x 4 and of 4 x 2) at GPT-2's 16 heads in its table of 64
    pages, each at the split edges of its own row count (the geometry
    follows B).  Two calls give bit-identical output (the splits merge in
    a fixed order, no atomics)."""
    rng = np.random.default_rng([C, tree, B, n_pg])
    group, ps = 1, 16
    S = n_pg * ps
    geo = ops._verify_geometry(B, C, Hkv, Hkv, ps, 64, n_pg)
    runs = _batches(_split_edge_bases(C, Hkv, group, ps, n_pg, B)
                    + [2 * geo.pps * ps - C], B, S)
    ops.reset_launch_counts()
    for base_np in runs:
        q, kp, vp, base, bt = _verify_case(rng, h100, B, C, Hkv, group,
                                           base_np, qdtype, n_pg=n_pg)
        anc = (torch.from_numpy(_tree_anc(rng, B, C)).to(h100) if tree
               else None)
        got = ops.paged_verify(q, kp, vp, base, bt, anc=anc)
        again = ops.paged_verify(q, kp, vp, base, bt, anc=anc)
        want = ref.paged_verify_ref(q, kp, vp, base, bt, anc=anc)
        torch.cuda.synchronize()
        live = base < S
        assert _rel_err(got[live], want[live]) <= ATTN_REL_TOL
        assert bool(torch.isfinite(got).all())
        assert torch.equal(got, again)
    n = ops.launch_counts()
    assert n["paged_verify_tree" if tree else "paged_verify"] == 2 * len(runs)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("group", [2, 4])
@pytest.mark.parametrize("C", [5, 32])
def test_paged_verify_gqa_on_card(h100, window, group, C):
    """The causal body with 2 and 4 query heads per KV head (8 and 4
    queries per 16-row tile), with and without a window."""
    rng = np.random.default_rng(100 + window + group + C)
    Hkv, ps, n_pg = 4, 16, 20
    base_np = [0, 3, 16, 77, 150, n_pg * ps - C]
    q, kp, vp, base, bt = _verify_case(rng, h100, len(base_np), C, Hkv,
                                       group, base_np, n_pg=n_pg)
    got = ops.paged_verify(q, kp, vp, base, bt, window=window)
    want = ref.paged_verify_ref(q, kp, vp, base, bt, window=window)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= ATTN_REL_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
def test_paged_verify_tree_c33_on_card(h100, qdtype):
    """A 33-position tree chunk: three query tiles, two bit words per
    query's ancestor row; random trees and a mask that is not triangular."""
    rng = np.random.default_rng(33)
    C, Hkv, group, n_pg = 33, 4, 2, 16
    base_np = [0, 15, 16, 100, n_pg * 16 - C, n_pg * 16]
    q, kp, vp, base, bt = _verify_case(rng, h100, len(base_np), C, Hkv,
                                       group, base_np, qdtype, n_pg=n_pg)
    for anc_np in (_tree_anc(rng, len(base_np), C),
                   rng.integers(0, 2, (len(base_np), C, C)).astype(np.int32)):
        anc = torch.from_numpy(anc_np).to(h100)
        got = ops.paged_verify(q, kp, vp, base, bt, anc=anc)
        want = ref.paged_verify_ref(q, kp, vp, base, bt, anc=anc)
        torch.cuda.synchronize()
        assert _rel_err(got[:-1], want[:-1]) <= ATTN_REL_TOL
        assert bool(torch.isfinite(got).all())


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [5, 9, 32])
def test_paged_verify_tril_bitexact_on_card(h100, qdtype, C):
    """A lower-triangular tree mask gives output bit-identical to the
    causal kernel at the serving widths (16 heads of 64, several key
    splits), with rows at split edges and a parked row."""
    rng = np.random.default_rng(200 + C)
    Hkv, group, ps, n_pg = 16, 1, 16, 64
    base_np = _split_edge_bases(C, Hkv, group, ps, n_pg, B=7)
    q, kp, vp, base, bt = _verify_case(rng, h100, len(base_np), C, Hkv,
                                       group, base_np, qdtype, n_pg=n_pg)
    tril = torch.tril(torch.ones((len(base_np), C, C), dtype=torch.int32,
                                 device=h100))
    got = ops.paged_verify(q, kp, vp, base, bt, anc=tril)
    causal = ops.paged_verify(q, kp, vp, base, bt)
    torch.cuda.synchronize()
    assert torch.equal(got, causal)


@pytest.mark.gpu
def test_paged_verify_makes_no_host_sync_on_card(h100):
    """The wrapper (geometry, scratch, both launches) never waits for the
    card: it runs under ``set_sync_debug_mode("error")``."""
    rng = np.random.default_rng(7)
    C = 9
    q, kp, vp, base, bt = _verify_case(rng, h100, 3, C, 4, 2, [0, 40, 200])
    anc = torch.from_numpy(_tree_anc(rng, 3, C)).to(h100)
    ops.paged_verify(q, kp, vp, base, bt)  # build and load the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.paged_verify(q, kp, vp, base, bt)
        ops.paged_verify(q, kp, vp, base, bt, window=5)
        ops.paged_verify(q, kp, vp, base, bt, anc=anc)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 7])
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kvdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hkv,group,S", [(2, 2, 100), (16, 1, 64)])
def test_mha_decode_kernel_matches_plain_on_card(h100, window, qdtype,
                                                 kvdtype, Hkv, group, S):
    """Ragged and tile-multiple cache widths, lengths from one key to the
    whole row; a row with no valid key returns zeros (the plain version,
    like the JAX oracle, returns NaN there, so it is left out of the
    comparison)."""
    rng = np.random.default_rng(window + Hkv + S)
    B, D = 4, 64
    k, v = (torch.from_numpy(rng.standard_normal(
        (B, Hkv, S, D)).astype(np.float32)).to(
            device=h100, dtype=getattr(torch, kvdtype)) for _ in range(2))
    lengths = torch.tensor([1, 37, S, 0], dtype=torch.int32, device=h100)
    q = torch.from_numpy(rng.standard_normal((B, Hkv * group, D)).astype(
        np.float32)).to(device=h100, dtype=getattr(torch, qdtype))
    ops.reset_launch_counts()
    got = ops.mha_decode(q, k, v, lengths, window=window)
    want = ref.mha_decode_ref(q, k, v, lengths, window=window)
    torch.cuda.synchronize()
    assert got.dtype == q.dtype and got.shape == q.shape
    assert bool((got[3] == 0).all())
    assert _rel_err(got[:3], want[:3]) <= ATTN_REL_TOL
    assert ops.launch_counts()["mha_decode"] == 1


def _mha_case(rng, dev, lengths_np, Hkv, group, D, S, qdtype, kvdtype):
    """A contiguous cache (B, Hkv, S, D), lengths and a query for the
    split-KV contiguous decode cases."""
    B = len(lengths_np)
    k, v = (torch.from_numpy(rng.standard_normal(
        (B, Hkv, S, D)).astype(np.float32)).to(
            device=dev, dtype=getattr(torch, kvdtype)) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((B, Hkv * group, D)).astype(
        np.float32)).to(device=dev, dtype=getattr(torch, qdtype))
    lengths = torch.tensor(lengths_np, dtype=torch.int32, device=dev)
    return q, k, v, lengths


def _mha_split_lengths(H, Hkv, S, D, elem, B=9):
    """Nine rows: lengths 0, 1 and 16, one on each side of the first key
    split edge of the geometry at ``B`` rows, past the second, and S - 1
    and S."""
    geo = ops._mha_geometry(B, H, Hkv, S, D, elem)
    edge = geo.kps
    assert geo.splits >= 2, geo
    return [0, 1, 16, edge - 1, edge, edge + 1, min(2 * edge + 1, S - 2),
            S - 1, S]


_TYPES = ("float32", "bfloat16")
#: (B, Hkv, group, D, S, kvdtype, qdtype, window): 9 rows at every head
#: shape, cache and query type and window; a serving tick's 8 rows at
#: GPT-2's widths (the draft's and the stacked target's caches), group 4
#: at D 64 and group 16 at D 128, windows 0 and 128; a shard's 4 and 2
#: rows at GPT-2's widths with float32 queries
_MHA_EDGE_CASES = [
    (9, Hkv, group, D, S, kv, q, window)
    for Hkv, group, D, S in ((16, 1, 64, 1024), (4, 2, 64, 1000),
                             (2, 4, 16, 300), (1, 16, 128, 520),
                             (4, 1, 128, 77))
    for kv in _TYPES for q in _TYPES for window in (0, 7, 128)] + [
    (8, Hkv, 16 // Hkv, D, S, kv, q, window)
    for Hkv, D, S in ((16, 64, 1024), (16, 64, 1000), (4, 64, 1024),
                      (4, 64, 1000), (1, 128, 1000))
    for kv in _TYPES for q in _TYPES for window in (0, 128)] + [
    (B, 16, 1, 64, 1024, kv, "float32", window) for B in (4, 2)
    for kv in _TYPES for window in (0, 128)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,Hkv,group,D,S,kvdtype,qdtype,window",
                         _MHA_EDGE_CASES)
def test_mha_decode_split_edges_on_card(h100, B, Hkv, group, D, S, kvdtype,
                                        qdtype, window):
    """Rows of lengths 0, 1, 16, at key-split edges +-1, S - 1 and S, with
    windows that stay inside a split or cross its edge; all heads, GQA
    groups 2 and 4 and a group of 16 on one KV head at D 128 (two head
    chunks); head dims 16, 64 and 128; ragged S; q and the cache each in
    float32 and bf16; calls of 9 rows, of a serving tick's 8 (GPT-2's
    draft and stacked caches, group 4 at D 64, group 16 at D 128) and of a
    shard's 4 and 2, each at the split edges of its own row count.  Each
    output vector within 1e-2 of its largest magnitude, an empty row
    exactly 0, two calls bit-identical, one launch counted per call."""
    rng = np.random.default_rng([window, group, D, S, B])
    elem = 2 if kvdtype == "bfloat16" else 4
    runs = _batches(_mha_split_lengths(Hkv * group, Hkv, S, D, elem, B), B,
                    S)
    ops.reset_launch_counts()
    for lengths_np in runs:
        q, k, v, lengths = _mha_case(rng, h100, lengths_np, Hkv, group, D,
                                     S, qdtype, kvdtype)
        got = ops.mha_decode(q, k, v, lengths, window=window)
        again = ops.mha_decode(q, k, v, lengths, window=window)
        want = ref.mha_decode_ref(q, k, v, lengths, window=window)
        torch.cuda.synchronize()
        live = lengths > 0
        assert got.dtype == q.dtype and got.shape == q.shape
        assert bool((got[~live] == 0).all())  # no valid key: 0, not NaN
        assert _rel_err(got[live], want[live]) <= ATTN_REL_TOL
        assert torch.equal(got, again)
    assert ops.launch_counts()["mha_decode"] == 2 * len(runs)


@pytest.mark.gpu
def test_mha_decode_makes_no_host_sync_on_card(h100):
    """The wrapper (geometry, scratch, both launches) never waits for the
    card: it runs under ``set_sync_debug_mode("error")``."""
    rng = np.random.default_rng(9)
    q, k, v, lengths = _mha_case(rng, h100, [0, 40, 300], 4, 2, 64, 333,
                                 "float32", "float32")
    ops.mha_decode(q, k, v, lengths)  # build and load
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.mha_decode(q, k, v, lengths)
        ops.mha_decode(q, k, v, lengths, window=5)
        ops.mha_decode(q.bfloat16(), k.bfloat16(), v.bfloat16(), lengths)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_engine_on_card_runs_every_kernel(h100):
    """The reduced W8A8 engine on the card (its default device): every
    linear, prefill chunk and decode step goes through its kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServeEngine

    cfg = get_config("gpt2-345m").reduced()
    params = lm.init(cfg, torch.Generator(device=h100).manual_seed(0),
                     max_seq=64, device=h100)
    calib = [np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 16))]
    eng = ServeEngine(cfg, params, batch_slots=2, max_seq=64, eos_id=-1,
                      quantized=True, calibration_batches=calib,
                      chunk_size=16)
    assert eng.device.type == "cuda"
    for n in (5, 30, 12):
        eng.submit(list(range(1, n + 1)), max_new=4)
    ops.reset_launch_counts()
    done = eng.run()
    s, n = eng.stats(), ops.launch_counts()
    assert len(done) == 3 and all(len(r.out) == 4 for r in done)
    L = cfg.n_layers
    assert n["mp_matmul"] == 6 * L * s["model_calls"]
    assert n["paged_verify"] == L * s["prefill_calls"]
    assert n["paged_mha_decode"] == L * (s["model_calls"]
                                         - s["prefill_calls"])
    # every W8A8 linear quantizes its input in one launch
    assert n["quant_act"] == 6 * L * s["model_calls"] > 0


@pytest.mark.gpu
def test_spec_engine_on_card_runs_the_new_kernels(h100):
    """Tree speculation with a draft model on the card: the verify goes
    through the tree-masked kernel and every draft decode step through
    the contiguous decode kernel; chain speculation verifies through the
    causal kernel.  Every request gets its tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.speculative import SpecConfig

    cfg = get_config("gpt2-345m").reduced()
    params = lm.init(cfg, torch.Generator(device=h100).manual_seed(0),
                     max_seq=64, device=h100)
    draft = lm.init(cfg, torch.Generator(device=h100).manual_seed(1),
                    max_seq=64, device=h100)
    L = cfg.n_layers
    for spec in (SpecConfig(k=4, proposer="model", draft_cfg=cfg,
                            draft_params=draft, tree=True, branch=2),
                 SpecConfig(k=3)):
        eng = ServeEngine(cfg, params, batch_slots=2, max_seq=64, eos_id=-1,
                          chunk_size=16, act_dtype=torch.float32, spec=spec)
        for n in (5, 30, 12):
            eng.submit(([3, 4, 5] * n)[:n], max_new=6)
        ops.reset_launch_counts()
        done = eng.run()
        s, n = eng.stats(), ops.launch_counts()
        assert len(done) == 3 and all(len(r.out) == 6 for r in done)
        assert s["spec_ticks"] > 0 and s["pages_in_use"] == 0
        if spec.tree:
            assert n["paged_verify_tree"] == L * s["spec_ticks"]
            assert n["mha_decode"] > 0
            assert n["paged_verify"] == L * s["prefill_calls"]
        else:
            assert n["paged_verify_tree"] == n["mha_decode"] == 0
            assert n["paged_verify"] == L * (s["prefill_calls"]
                                             + s["spec_ticks"])


def _bf16_ulp(a: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values around float32 ``a``."""
    mag = a.abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _ln_res_faults(got, want):
    """What ``got`` gets wrong against ``want`` under the module's
    ``ln_res`` tolerances; an empty list when it holds."""
    bad = []
    if not torch.equal(got[1], want[1]):
        bad.append("r not bit-identical")
    if not ((got[3] - want[3]).abs() <= 1e-5 * want[3].abs()).all():
        bad.append("scale beyond 1e-5 relative")
    gy, wy = got[0].float(), want[0].float()
    if not ((gy - wy).abs() <= torch.maximum(_bf16_ulp(gy),
                                             _bf16_ulp(wy))).all():
        bad.append("y beyond one bf16 ulp")
    dq = (got[2].int() - want[2].int()).abs()
    if dq.max().item() > 1 or (dq == 0).float().mean().item() < 0.999:
        bad.append("y_q beyond 1 or equal on < 99.9%")
    return bad


def _ln_res_inputs(rng, B, D, dtype, dev, mean=0.0):
    x = torch.from_numpy(3 * rng.standard_normal((B, D)).astype(np.float32))
    res = torch.from_numpy((rng.standard_normal((B, D)) + mean).astype(
        np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 1.5, D).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal(D)).astype(np.float32))
    return (x.to(dev, dtype), res.to(dev, dtype), w.to(dev), b.to(dev))


_LN_CASES = [(B, D, 3000.0 if B == 5 else 0.0) for B, D in (
    (8, 1024), (256, 1024), (32, 4096), (5, 1000), (3, 8192), (2, 16384),
    (3, 256), (5, 200), (33, 100), (8, 64), (33, 257), (3, 2056),
    (3, 8200))]
# every serving row count at GPT-2's and the family's widths, a ragged one
# and a warp's, a prefill chunk's rows with a large mean
_LN_CASES += [case for case in [
    (B, D, 3000.0 if B == 32 else 0.0) for B in (5, 8, 32, 256)
    for D in (1024, 4096, 1000, 256)] if case not in _LN_CASES]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,D,mean", _LN_CASES)
def test_ln_res_kernel_matches_plain_on_card(h100, kind, dtype, B, D, mean):
    """Decode and prefill rows at GPT-2's width, wider rows up to the
    16,384 columns a block holds (8,200 and 16,384: 8 chunks a thread),
    narrow rows that leave most of a row's 256 threads idle, odd row
    counts (3, 5, 33), ragged widths (1000, 200, and 257 and 100, which
    take element-wise accesses), rows with a large mean; one launch
    counted per call."""
    rng = np.random.default_rng([B, D, int(mean)])
    x, res, w, b = _ln_res_inputs(rng, B, D, getattr(torch, dtype), h100,
                                  mean=mean)
    ops.reset_launch_counts()
    got = ops.ln_res(x, res, w, b, kind=kind)
    assert ops.launch_counts()["ln_res"] == 1
    want = ref.ln_res_ref(x, res, w, b, kind=kind)
    torch.cuda.synchronize()
    assert [t.shape for t in got] == [t.shape for t in want]
    assert [t.dtype for t in got] == [t.dtype for t in want]
    assert _ln_res_faults(got, want) == []


@pytest.mark.gpu
def test_ln_res_check_rejects_a_one_pass_variance(h100):
    """A planted fault: the variance taken as E[r^2] - mean^2 on rows
    with a large mean (float32 cancellation) must fail the check that
    the kernel passes."""
    rng = np.random.default_rng(1)
    x, res, w, b = _ln_res_inputs(rng, 8, 1024, torch.float32, h100,
                                  mean=3000.0)
    want = ref.ln_res_ref(x, res, w, b)
    assert _ln_res_faults(ops.ln_res(x, res, w, b), want) == []
    r = x + res
    mu = r.mean(-1, keepdim=True)
    var = (r * r).mean(-1, keepdim=True) - mu * mu
    y = (r - mu) * (1.0 / torch.sqrt(var.clamp_min(0) + 1e-5)) * w + b
    sc = y.abs().amax(-1, keepdim=True).clamp(min=1e-6) / 127.0
    planted = (y.to(torch.bfloat16), r,
               torch.round(y / sc).clamp(-127, 127).to(torch.int8), sc)
    assert _ln_res_faults(planted, want)


def _quant_act_inputs(rng, M, K, dtype, dev, offset=0):
    """Rows of mixed magnitudes, one all zeros, and smoothing factors
    spread log-uniformly over [1e-3, 1e3] (``smooth_factors``' clamp);
    ``offset`` elements in front of x leave it contiguous but not 16-byte
    aligned."""
    x = rng.standard_normal((M, K)) * rng.uniform(0.01, 50, (M, 1))
    x[M // 2] = 0.0
    s = np.exp(rng.uniform(np.log(1e-3), np.log(1e3), K))
    flat = torch.zeros(offset + M * K, dtype=dtype, device=dev)
    flat[offset:] = torch.from_numpy(x.astype(np.float32)).reshape(-1).to(
        dev, dtype)
    return (flat[offset:].view(M, K),
            torch.from_numpy(s.astype(np.float32)).to(dev))


_QA_CASES = [(M, K, 0) for M in (1, 8, 32, 127, 128, 1500)
             for K in (1024, 1280, 4096, 5120, 14336, 24576)] + [
    (M, K, 0) for M in (1, 127) for K in (1027, 3, 100)] + [
    (32, 1027, 0), (1500, 1027, 0),
    (127, 1024, 1), (8, 14336, 2), (3, 24576, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,offset", _QA_CASES)
def test_quant_act_kernel_bitexact_on_card(h100, dtype, M, K, offset):
    """Every row count the engines send (a decode step, a prefill chunk,
    whisper's encoder) at the configs' widths (GPT-2 and whisper, the
    RoPE family's and gemma's widest, two passes past 16,384 columns),
    ragged widths (scalar accesses), contiguous rows that start off a
    16-byte boundary: ``x_q`` and ``scale`` bit-identical to the plain
    version run on the CPU, not to ATen on the card, which may divide by
    the scalar 127 as a multiply by its reciprocal; one launch a call."""
    rng = np.random.default_rng(M * 7 + K + offset)
    x, s = _quant_act_inputs(rng, M, K, getattr(torch, dtype), h100, offset)
    ops.reset_launch_counts()
    q, sc = ops.quant_act(x, s)
    assert ops.launch_counts()["quant_act"] == 1
    wq, wsc = ref.quant_act_ref(x.cpu(), s.cpu())
    assert q.device == h100 and q.dtype == torch.int8 and q.shape == (M, K)
    assert sc.dtype == torch.float32 and sc.shape == (M, 1)
    assert torch.equal(q.cpu(), wq) and torch.equal(sc.cpu(), wsc)


@pytest.mark.gpu
def test_quant_act_makes_no_host_sync_on_card(h100):
    """The activation quantization never waits for the card: it runs
    under ``set_sync_debug_mode("error")`` at every path of the kernel
    (registers, two passes, scalar accesses, bf16)."""
    rng = np.random.default_rng(4)
    cases = [_quant_act_inputs(rng, M, K, dt, h100)
             for M, K, dt in ((127, 1024, torch.float32),
                              (32, 4096, torch.bfloat16),
                              (8, 24576, torch.float32),
                              (5, 1027, torch.float32))]
    for x, s in cases:  # build and load
        ops.quant_act(x, s)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for x, s in cases:
            ops.quant_act(x, s)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_stacked_and_overcommit_engines_on_card(h100):
    """The stacked layout decodes the target through the contiguous
    decode kernel; an over-committed paged pool preempts (a host restore
    and a recompute resume) and drains.  Every request gets its tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving.admission import OvercommitAdmission
    from repro_torch.serving.engine import ServeEngine

    cfg = get_config("gpt2-345m").reduced()
    params = lm.init(cfg, torch.Generator(device=h100).manual_seed(0),
                     max_seq=64, device=h100)
    L = cfg.n_layers
    eng = ServeEngine(cfg, params, batch_slots=2, max_seq=64, eos_id=-1,
                      chunk_size=16, kv_layout="stacked")
    for n in (5, 30, 12):
        eng.submit(list(range(1, n + 1)), max_new=4)
    ops.reset_launch_counts()
    done = eng.run()
    s, n = eng.stats(), ops.launch_counts()
    assert len(done) == 3 and all(len(r.out) == 4 for r in done)
    assert n["mha_decode"] == L * (s["model_calls"] - s["prefill_calls"])
    assert n["paged_mha_decode"] == n["paged_verify"] == 0

    eng = ServeEngine(cfg, params, batch_slots=3, max_seq=64, eos_id=-1,
                      chunk_size=8, page_size=16, n_pages=4,
                      prefix_sharing=False,
                      admission=OvercommitAdmission(cfg, chunk_size=8))
    for n in (10, 10, 10):
        eng.submit(list(range(n, 2 * n)), max_new=20)
    for _ in range(4):
        eng.tick()
    dec = [r for r in eng.slots if r is not None and r.out]
    if dec:
        eng._preempt(dec[0], "recompute")
    done = eng.run()
    s = eng.stats()
    assert len(done) == 3 and all(len(r.out) == 20 for r in done)
    assert s["preemptions"] >= 1 and s["restores"] == s["preemptions"]
    assert s["pages_in_use"] == 0


# ---------------------------------------------------------------------------
# the RoPE family's linears: llama3-8b (4096 -> 1024 k/v, 14336 FFN, an
# untied head of 128,256), minitron-4b (9216 FFN, a head of 256,000) and
# gemma-7b (4096-wide q, 24,576 FFN)


_FAMILY_WIDTHS = [(4096, 1024), (4096, 14336), (14336, 4096), (3072, 9216),
                  (9216, 3072), (3072, 24576), (24576, 3072), (4096, 128256),
                  (3072, 256000)]
#: the rest of the family's quantized shapes: llama3-8b's and gemma-7b's q
#: and out, minitron-4b's k, v, q and out
_FAMILY_OTHER_WIDTHS = [(4096, 4096), (3072, 1024), (3072, 3072),
                        (3072, 4096), (4096, 3072)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,out_dtype", [
    (M, K, N, "float32") for M in (1, 8, 32, 40, 72)
    for K, N in _FAMILY_WIDTHS] + [
    (M, K, N, "bfloat16") for M in (8, 32, 40)
    for K, N in _FAMILY_WIDTHS + _FAMILY_OTHER_WIDTHS])
def test_mp_matmul_bitexact_at_family_widths_on_card(h100, M, K, N,
                                                     out_dtype):
    """The W8A8 kernel at the family's weight shapes, at a decode tick's,
    a prefill chunk's and the verifies' token counts, with bias, float32
    out (a W8A8 engine's activations); and at every quantized shape of
    the family's layers and heads with bf16 out at a decode tick's, a
    prefill chunk's and a chain verify's: bit-identical, twice."""
    rng = np.random.default_rng(M + K + N)
    args = _mp_case(rng, M, K, N, True, h100)
    dt = getattr(torch, out_dtype)
    got = ops.quant_matmul(*args, out_dtype=dt)
    again = ops.quant_matmul(*args, out_dtype=dt)
    want = ref.quant_matmul_ref(*args, out_dtype=dt)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, again)


# ---------------------------------------------------------------------------
# head dim 256 (gemma-7b) and the RoPE family's groups: 3 (minitron-4b), 4
# (llama3-8b), 8 (tinyllama-1.1b), 1 (gemma-7b), and 16 x D 256 on the
# contiguous decode (recurrentgemma's local attention)

#: (Hkv, group, D) of the decode and verify cases
_WIDE_SHAPES = [(2, 1, 128), (2, 3, 128), (2, 4, 128), (2, 8, 128),
                (2, 1, 256), (2, 3, 256), (2, 4, 256), (2, 8, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hkv,group,D", _WIDE_SHAPES)
def test_paged_mha_decode_wide_heads_and_groups_on_card(h100, window, qdtype,
                                                        Hkv, group, D):
    """The paged decode at head dims 128 and 256 with groups 1, 3, 4 and
    8: rows of lengths 0, 1, 16, at key-split edges +-1 and at the end of
    the table.  Each output vector within 1e-2 of its largest magnitude,
    the empty row exactly 0, two calls bit-identical."""
    rng = np.random.default_rng(300 + window + group + D)
    ps, n_pg = 16, 40
    lengths_np = _decode_split_lengths(Hkv * group, Hkv, ps, D, n_pg)
    q, kp, vp, lengths, bt = _decode_case(rng, h100, lengths_np, Hkv, group,
                                          D, ps, n_pg, qdtype)
    got = ops.paged_mha_decode(q, kp, vp, lengths, bt, window=window)
    again = ops.paged_mha_decode(q, kp, vp, lengths, bt, window=window)
    want = ref.paged_mha_decode_ref(q, kp, vp, lengths, bt, window=window)
    torch.cuda.synchronize()
    assert bool((got[0] == 0).all())
    assert _rel_err(got[1:], want[1:]) <= ATTN_REL_TOL
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [5, 32])
@pytest.mark.parametrize("Hkv,group,D", _WIDE_SHAPES)
def test_paged_verify_wide_heads_and_groups_on_card(h100, tree, qdtype, C,
                                                    Hkv, group, D):
    """Both verify bodies at head dims 128 and 256 (where Q is staged in
    shared memory) with groups 1, 3, 4 and 8 (16 // group queries per
    16-row tile: 15 rows used at group 3): rows ending on a key-split
    edge, past it and a page past it, at base 0, at the end of the table
    and parked.  Each vector within 1e-2, two calls bit-identical, and a
    lower-triangular mask bit-identical to the causal kernel."""
    rng = np.random.default_rng(400 + C + group + D + 2 * tree)
    ps, n_pg = 16, 24
    base_np = _split_edge_bases(C, Hkv, group, ps, n_pg)
    B = len(base_np)
    q, kp, vp, base, bt = _verify_case(rng, h100, B, C, Hkv, group, base_np,
                                       qdtype, D=D, n_pg=n_pg)
    anc = torch.from_numpy(_tree_anc(rng, B, C)).to(h100) if tree else None
    got = ops.paged_verify(q, kp, vp, base, bt, anc=anc)
    again = ops.paged_verify(q, kp, vp, base, bt, anc=anc)
    want = ref.paged_verify_ref(q, kp, vp, base, bt, anc=anc)
    torch.cuda.synchronize()
    assert _rel_err(got[:-1], want[:-1]) <= ATTN_REL_TOL
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    if not tree:
        tril = torch.tril(torch.ones((B, C, C), dtype=torch.int32,
                                     device=h100))
        assert torch.equal(ops.paged_verify(q, kp, vp, base, bt, anc=tril),
                           got)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 128])
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kvdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Hkv,group,D", _WIDE_SHAPES + [(1, 16, 256)])
def test_mha_decode_wide_heads_and_groups_on_card(h100, window, qdtype,
                                                  kvdtype, Hkv, group, D):
    """The contiguous decode at head dims 128 and 256 with groups 1, 3, 4,
    8 and 16 (two head chunks); a float32 cache at D 256 runs blocks of 2
    warps.  Rows of lengths 0, 1, 16, at key-split edges +-1, S - 1 and S;
    each vector within 1e-2, the empty row 0, two calls bit-identical."""
    rng = np.random.default_rng(500 + window + group + D)
    S = 520
    elem = 2 if kvdtype == "bfloat16" else 4
    lengths_np = _mha_split_lengths(Hkv * group, Hkv, S, D, elem)
    q, k, v, lengths = _mha_case(rng, h100, lengths_np, Hkv, group, D, S,
                                 qdtype, kvdtype)
    got = ops.mha_decode(q, k, v, lengths, window=window)
    again = ops.mha_decode(q, k, v, lengths, window=window)
    want = ref.mha_decode_ref(q, k, v, lengths, window=window)
    torch.cuda.synchronize()
    assert bool((got[0] == 0).all())
    assert _rel_err(got[1:], want[1:]) <= ATTN_REL_TOL
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_wide_heads_make_no_host_sync_on_card(h100):
    """At head dim 256 the three attention wrappers never wait for the
    card (``set_sync_debug_mode("error")``)."""
    rng = np.random.default_rng(11)
    qd, kp, vp, lengths, bt = _decode_case(rng, h100, [0, 40, 300], 2, 1,
                                           256)
    qv, kv, vv, base, btv = _verify_case(rng, h100, 3, 9, 2, 4, [0, 40, 200],
                                         D=256)
    qm, km, vm, lm_ = _mha_case(rng, h100, [0, 40, 300], 2, 4, 256, 333,
                                "float32", "float32")
    calls = (lambda: ops.paged_mha_decode(qd, kp, vp, lengths, bt),
             lambda: ops.paged_verify(qv, kv, vv, base, btv),
             lambda: ops.mha_decode(qm, km, vm, lm_))
    for fn in calls:  # build and load
        fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn in calls:
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3-8b", "gemma-7b"])
def test_rope_engine_on_card_runs_every_kernel(h100, arch):
    """A reduced RoPE config's W8A8 engine on the card, paged with chain
    speculation and stacked: every linear, prefill chunk, verify and
    decode step goes through its kernel, and every request gets its
    tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.speculative import SpecConfig

    cfg = get_config(arch).reduced()
    params = lm.init(cfg, torch.Generator(device=h100).manual_seed(0),
                     device=h100)
    calib = [np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 16))]
    L = cfg.n_layers
    n_mp = 7 if cfg.activation in ("swiglu", "geglu") else 6
    n_mp_head = 0 if cfg.tie_embeddings else 1
    for layout, spec in (("paged", SpecConfig(k=3)), ("stacked", None)):
        eng = ServeEngine(cfg, params, batch_slots=2, max_seq=64, eos_id=-1,
                          quantized=True, calibration_batches=calib,
                          chunk_size=16, kv_layout=layout, spec=spec)
        for n in (5, 30, 12):
            eng.submit(([3, 4, 5] * n)[:n], max_new=6)
        ops.reset_launch_counts()
        done = eng.run()
        s, n = eng.stats(), ops.launch_counts()
        assert len(done) == 3 and all(len(r.out) == 6 for r in done)
        assert n["mp_matmul"] == (n_mp * L + n_mp_head) * s["model_calls"]
        decodes = (s["model_calls"] - s["prefill_calls"]
                   - s.get("spec_ticks", 0))
        if layout == "paged":
            assert s["spec_ticks"] > 0
            assert n["paged_verify"] == L * (s["prefill_calls"]
                                             + s["spec_ticks"])
            assert n["paged_mha_decode"] == L * decodes
        else:
            assert n["mha_decode"] == L * decodes > 0


# ---------------------------------------------------------------------------
# the MoE decoders: olmoe-1b-7b's linears (q, k, v and out at 2048 x 2048,
# the untied head of 50,304; the experts stay float) and the reduced MoE
# engines


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N", [(2048, 2048), (2048, 50304)])
@pytest.mark.parametrize("M", [8, 32, 40])
def test_mp_matmul_bitexact_at_olmoe_widths_on_card(h100, M, K, N,
                                                    out_dtype):
    """The W8A8 kernel at olmoe-1b-7b's quantized weight shapes, at a
    decode tick's, a prefill chunk's and a chain verify's token counts,
    with bias, float32 and bf16 out: bit-identical, twice."""
    rng = np.random.default_rng(M + K + N + 1)
    args = _mp_case(rng, M, K, N, True, h100)
    dt = getattr(torch, out_dtype)
    got = ops.quant_matmul(*args, out_dtype=dt)
    again = ops.quant_matmul(*args, out_dtype=dt)
    want = ref.quant_matmul_ref(*args, out_dtype=dt)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "kimi-k2-1t-a32b"])
def test_moe_apply_on_card_makes_no_host_sync(h100, arch):
    """The MoE FFN on the card never waits for it (its capacity comes from
    the shapes alone), at exact capacity and with drops, and agrees with
    the CPU: the same expert choices and slots, float32 outputs within
    ``1e-5``.  The card's float32 products stay float32 (no TF32)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.layers import to_device

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config(arch).reduced()
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    pd = to_device(p, h100)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, 5, cfg.d_model)).astype(np.float32))
    xd = x.to(h100)
    for cf in (None, 1.25):
        moe.moe_apply(pd, xd, cfg, capacity_factor=cf)  # cuBLAS set-up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, aux = moe.moe_apply(pd, xd, cfg, capacity_factor=cf)
            route = moe.route(pd, xd.reshape(-1, cfg.d_model), cfg, cf)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        want, want_aux = moe.moe_apply(p, x, cfg, capacity_factor=cf)
        want_route = moe.route(p, x.reshape(-1, cfg.d_model), cfg, cf)
        assert torch.equal(route[1].cpu(), want_route[1])
        assert torch.equal(route[2].cpu(), want_route[2])
        torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=1e-5)
        assert abs(float(aux) - float(want_aux)) <= 1e-6


@pytest.mark.gpu
def test_moe_apply_at_full_width_on_card_matches_cpu(h100):
    """One full-width ``olmoe-1b-7b`` layer's MoE FFN (64 float32 experts
    of 2,048 x 1,024, top 8, exact capacity, the padded products) at a
    decode tick's 8 tokens and a prefill chunk's 32: the output finite;
    at 8 tokens the CPU's expert choices and, per output row, within 1e-4
    of its largest magnitude."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.layers import to_device

    cfg = get_config("olmoe-1b-7b")
    d = cfg.d_model
    p = moe.moe_init(torch.Generator(device=h100).manual_seed(5), cfg,
                     device=h100)
    rng = np.random.default_rng(10)
    for T, shape in ((8, (8, 1, d)), (32, (1, 32, d))):
        x = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(h100)
        out, aux = moe.moe_apply(p, x, cfg)
        assert out.shape == x.shape and bool(torch.isfinite(out).all())
        assert bool(torch.isfinite(aux))
        if T == 8:
            pc = to_device(p, torch.device("cpu"))
            want, _ = moe.moe_apply(pc, x.cpu(), cfg)
            xt = x.reshape(T, d)
            assert torch.equal(moe.route(p, xt, cfg, None).experts.cpu(),
                               moe.route(pc, xt.cpu(), cfg, None).experts)
            assert _rel_err(out.cpu().reshape(T, d),
                            want.reshape(T, d)) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "kimi-k2-1t-a32b"])
def test_moe_engine_on_card_runs_every_kernel(h100, arch):
    """A reduced MoE config's W8A8 engine on the card: paged plain, chain
    speculation, tree speculation with a draft model, and stacked plain.
    Every quantized linear (q, k, v, out and the head; the experts stay
    float) goes through the MP kernel, every prefill chunk and verify
    through its verify body, every decode step through its decode kernel,
    and every request gets its tokens."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import noisy_copy
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.speculative import SpecConfig

    cfg = get_config(arch).reduced()
    params = lm.init(cfg, torch.Generator(device=h100).manual_seed(0),
                     device=h100)
    draft = noisy_copy(params, 1)
    calib = [np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 16))]
    L = cfg.n_layers
    runs = (("paged", None), ("paged", SpecConfig(k=3)),
            ("paged", SpecConfig(k=4, proposer="model", draft_cfg=cfg,
                                 draft_params=draft, tree=True, branch=2)),
            ("stacked", None))
    for layout, spec in runs:
        eng = ServeEngine(cfg, params, batch_slots=2, max_seq=64, eos_id=-1,
                          quantized=True, calibration_batches=calib,
                          chunk_size=16, kv_layout=layout, spec=spec)
        assert eng.device.type == "cuda"
        for n in (5, 30, 12):
            eng.submit(([3, 4, 5] * n)[:n], max_new=6)
        ops.reset_launch_counts()
        done = eng.run()
        s, n = eng.stats(), ops.launch_counts()
        assert len(done) == 3 and all(len(r.out) == 6 for r in done)
        assert n["mp_matmul"] == (4 * L + 1) * s["model_calls"]
        verifies = s.get("spec_ticks", 0)
        decodes = s["model_calls"] - s["prefill_calls"] - verifies
        if spec is not None:
            assert verifies > 0
        if layout == "stacked":
            assert n["mha_decode"] == L * decodes > 0
            assert n["paged_verify"] == n["paged_mha_decode"] == 0
        elif spec is not None and spec.tree:
            assert n["paged_verify_tree"] == L * verifies
            assert n["paged_verify"] == L * s["prefill_calls"]
            assert n["mha_decode"] > 0  # the draft's steps
        else:
            assert n["paged_verify"] == L * (s["prefill_calls"] + verifies)
            assert n["paged_verify_tree"] == n["mha_decode"] == 0
        assert n["paged_mha_decode"] == (0 if layout == "stacked"
                                         else L * decodes)


# the grouped experts (``ops.moe_experts``) at olmoe-1b-7b-0924's widths:
# d 2,048, f 1,024, 64 bf16 experts, top 8, a float32 stream
MOE_D, MOE_F, MOE_E, MOE_K = 2048, 1024, 64, 8
#: per output row, the largest error over the row's largest magnitude, and
#: the share of elements that may differ at all: the kernel sums each
#: product over K in float32 in another order than cuBLAS, so a bf16
#: rounding of an output (or of the gate, up or hidden value feeding it)
#: can land one bf16 place away (2^-8 of the value; 2^-7 of the row's
#: largest covers a flip anywhere in the row); a dropped K stage moves every
#: element by about 1/128 of its sum
MOE_REL_TOL, MOE_DIFF_SHARE = 2 ** -7, 0.05


def _moe_banks(dev, seed=0):
    """The three bf16 banks of one layer, scaled as ``moe.moe_init``."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    kw = {"generator": gen, "device": dev}
    s_in, s_out = MOE_D ** -0.5, MOE_F ** -0.5
    return tuple((torch.randn(shape, **kw) * s).to(torch.bfloat16)
                 for shape, s in (((MOE_E, MOE_D, MOE_F), s_in),
                                  ((MOE_E, MOE_D, MOE_F), s_in),
                                  ((MOE_E, MOE_F, MOE_D), s_out)))


def _moe_choices(rng, T, hot=None):
    """Top-8 expert choices (T, 8) without repeats; with ``hot`` every
    token's first choice is that expert (it holds all T rows)."""
    ch = np.argsort(rng.random((T, MOE_E)), axis=1)[:, :MOE_K]
    if hot is not None:
        for row in ch:
            if hot in row:
                row[list(row).index(hot)] = row[0]
            row[0] = hot
    return torch.from_numpy(ch.astype(np.int64))


def _moe_close(got, want):
    """``got`` within ``MOE_REL_TOL`` of each row's largest magnitude of
    ``want``, and at most ``MOE_DIFF_SHARE`` of its elements different."""
    rel = _rel_err(got, want)
    share = (got != want).float().mean().item()
    assert rel <= MOE_REL_TOL and share <= MOE_DIFF_SHARE, (rel, share)


@pytest.mark.gpu
@pytest.mark.parametrize("T,hot,xdtype,activation", [
    (1, None, "float32", "swiglu"), (8, None, "float32", "swiglu"),
    (32, None, "float32", "swiglu"), (256, None, "float32", "swiglu"),
    (32, 3, "float32", "swiglu"), (256, 5, "float32", "swiglu"),
    (32, None, "bfloat16", "swiglu"), (32, None, "float32", "geglu")])
def test_moe_experts_kernel_against_plain_on_card(h100, T, hot, xdtype,
                                                  activation):
    """The grouped experts kernel against its plain version on the card
    (a per-expert loop of cuBLAS products) at the cell's widths: a single
    token, a decode step of 8 and of 32, a prefill of 256 (two m16 tiles a
    block); one expert holding every token (2 row tiles at T 32, 8 of 32
    rows at T 256); a bf16 stream; the tanh GELU.  Within
    ``MOE_REL_TOL`` per output row and ``MOE_DIFF_SHARE`` of elements;
    two calls bit-identical (a fixed order of the sums)."""
    from repro_torch.models import moe

    w_gate, w_up, w_down = _moe_banks(h100)
    rng = np.random.default_rng(T + (hot or 0))
    x = torch.from_numpy(rng.standard_normal((T, MOE_D)).astype(
        np.float32)).to(device=h100, dtype=getattr(torch, xdtype))
    experts = _moe_choices(rng, T, hot).to(h100)
    _, order, offsets = moe.sort_choices(experts, MOE_E, T * MOE_K)
    ops.reset_launch_counts()
    got = ops.moe_experts(x, order, offsets, w_gate, w_up, w_down, MOE_K,
                          activation=activation)
    again = ops.moe_experts(x, order, offsets, w_gate, w_up, w_down, MOE_K,
                            activation=activation)
    assert ops.launch_counts()["moe_experts"] == 4
    want = ref.moe_experts_ref(x, order, offsets, w_gate, w_up, w_down,
                               MOE_K, activation=activation)
    torch.cuda.synchronize()
    assert got.shape == (T * MOE_K, MOE_D) and got.dtype == torch.bfloat16
    assert torch.equal(got, again)
    _moe_close(got, want)


@pytest.mark.gpu
def test_grouped_moe_apply_on_card_launches_two_kernels_without_sync(h100):
    """One layer of OLMoE-1B-7B-0924's MoE FFN on the card (bf16 banks, a
    float32 stream, exact capacity) at a decode step's 32 tokens: no host
    sync (``set_sync_debug_mode("error")``), two ``moe_experts`` launches
    by ``launch_counts()`` and two CUDA functions of the kernel by
    ``torch.profiler``, no ``bmm`` and no product but the router's; the
    CPU's routing and, within ``MOE_REL_TOL`` per row, its output (the
    plain per-expert loop)."""
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.layers import to_device

    cfg = dataclasses.replace(
        get_config("olmoe-1b-7b"), expert_dtype="bfloat16",
        norm_topk_prob=False)
    p = moe.moe_init(torch.Generator(device=h100).manual_seed(0), cfg,
                     device=h100)
    for name in ("w_gate", "w_up", "w_down"):
        p[name] = p[name].to(torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (32, 1, cfg.d_model)).astype(np.float32)).to(h100)
    moe.moe_apply(p, x, cfg)  # build, load and warm up
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            got, _ = moe.moe_apply(p, x, cfg)
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ops.launch_counts()["moe_experts"] == 2
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    assert sum("experts_kernel" in k for k in kernels) == 2, kernels
    host = [e.name for e in prof.events() if e.device_type == DeviceType.CPU]
    # the router's (32, 2048) x (2048, 64) float32 product is the only one
    assert "aten::bmm" not in host and host.count("aten::mm") == 1, host
    assert sum("gemm" in k.lower() or "nvjet" in k for k in kernels) == 1, \
        kernels
    pc = to_device(p, torch.device("cpu"))
    xt = x.reshape(32, cfg.d_model)
    assert torch.equal(moe.route(p, xt, cfg, None).experts.cpu(),
                       moe.route(pc, xt.cpu(), cfg, None).experts)
    want, _ = moe.moe_apply(pc, x.cpu(), cfg)
    assert _rel_err(got.cpu().reshape(32, -1), want.reshape(32, -1)) \
        <= MOE_REL_TOL


@pytest.mark.gpu
def test_grouped_moe_engine_on_card_counts_its_launches(h100):
    """A reduced published-form engine on the card (64 bf16 experts of 32,
    top 8, raw gates; W8A8 attention): every model call's MoE layers go
    through the grouped kernels, two launches a layer, and every request
    gets its tokens."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServeEngine

    cfg = dataclasses.replace(
        get_config("olmoe-1b-7b").reduced(), n_experts=64,
        experts_per_token=8, d_ff=32, expert_dtype="bfloat16",
        norm_topk_prob=False)
    params = lm.init(cfg, torch.Generator(device=h100).manual_seed(0),
                     device=h100)
    calib = [np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 16))]
    eng = ServeEngine(cfg, params, batch_slots=2, max_seq=64, eos_id=-1,
                      quantized=True, calibration_batches=calib,
                      chunk_size=16)
    for n in (5, 30, 12):
        eng.submit(([3, 4, 5] * n)[:n], max_new=6)
    ops.reset_launch_counts()
    done = eng.run()
    s, n = eng.stats(), ops.launch_counts()
    assert len(done) == 3 and all(len(r.out) == 6 for r in done)
    assert n["moe_experts"] == 2 * cfg.n_layers * s["model_calls"] > 0


# ---------------------------------------------------------------------------
# the hybrid stacks: recurrentgemma-9b's ring decode (16 query heads over
# one KV head of 256 on a ring of 2,048) and linears, xlstm-350m's
# linears, and the reduced hybrid engines


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
def test_mha_decode_on_a_full_ring_on_card(h100, qdtype):
    """``recurrentgemma-9b``'s ring decode: 16 query heads over one KV
    head of 256, a bf16 ring of W = 2,048 slots, lengths W and W + 1 (a
    full ring passes ``min(len, W) + 1``), past the ring (3,000) and
    short rows.  Each vector within 1e-2 of its plain version's largest
    magnitude; rows W, W + 1 and 3,000 on the same query and ring are
    bit-identical (the kernel reads no further than the ring); two calls
    bit-identical."""
    rng = np.random.default_rng(19)
    W, B = 2048, 8
    q, k, v, lengths = _mha_case(rng, h100, [W, W + 1, 3000, 1, 17, W - 1,
                                             1000, W + 1], 1, 16, 256, W,
                                 qdtype, "bfloat16")
    for t in (q, k, v):
        t[1:3] = t[0]  # rows 0-2: one query and ring at three lengths
    ops.reset_launch_counts()
    got = ops.mha_decode(q, k, v, lengths)
    again = ops.mha_decode(q, k, v, lengths)
    want = ref.mha_decode_ref(q, k, v, lengths)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= ATTN_REL_TOL
    assert torch.equal(got[0], got[1]) and torch.equal(got[0], got[2])
    assert torch.equal(got, again)
    assert ops.launch_counts()["mha_decode"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N", [(4096, 8192), (4096, 4096), (4096, 256),
                                 (4096, 12288), (12288, 4096), (1024, 3072),
                                 (1024, 1024)])
@pytest.mark.parametrize("M", [8, 32, 40])
def test_mp_matmul_bitexact_at_hybrid_widths_on_card(h100, M, K, N,
                                                     out_dtype):
    """The W8A8 kernel at the hybrid stacks' quantized weight shapes:
    recurrentgemma-9b's ``in_proj`` (4096 x 8192), ``out_proj``, q and
    out (4096 x 4096), k and v (4096 x 256) and GeGLU MLP, xlstm-350m's
    ``qkv`` (1024 x 3072), ``o_gate`` and ``out``; at a decode tick's, a
    prefill chunk's and a chain verify's token counts, with bias, float32
    and bf16 out: bit-identical, twice."""
    rng = np.random.default_rng(M + K + N + 2)
    args = _mp_case(rng, M, K, N, True, h100)
    dt = getattr(torch, out_dtype)
    got = ops.quant_matmul(*args, out_dtype=dt)
    again = ops.quant_matmul(*args, out_dtype=dt)
    want = ref.quant_matmul_ref(*args, out_dtype=dt)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, again)


def _hybrid_w8a8(arch, dev):
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving.quantize import (calibrate,
                                              quantize_model_params)

    cfg = get_config(arch).reduced()
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0),
                     device=dev)
    calib = [np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 16))]
    return cfg, quantize_model_params(params, cfg,
                                      calibrate(params, cfg, calib))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-350m"])
def test_hybrid_decode_verify_commit_make_no_host_sync_on_card(h100, arch):
    """The hybrid decode step (rows riding along), the verify's ring
    snapshot, a chain verify with ``valids`` and its trajectory, and the
    commit never wait for the card (``set_sync_debug_mode("error")``):
    ring slots and trajectory entries are chosen on the device.  A prefill
    chunk first fills the caches."""
    from repro_torch.models import lm

    cfg, qp = _hybrid_w8a8(arch, h100)
    B, C = 4, 5
    cache = lm.init_cache(cfg, B, 64, layout="stacked", device=h100)
    toks = torch.arange(1, 1 + 40, device=h100) % cfg.vocab_size
    tok = torch.ones((B, 1), dtype=torch.int64, device=h100)
    lens = torch.tensor([16, 40, 0, 5], dtype=torch.int32, device=h100)
    active = torch.tensor([True, True, False, True], device=h100)
    vt = toks[:B * C].reshape(B, C)
    valids = torch.tensor([5, 3, 0, 1], dtype=torch.int32, device=h100)
    counts = torch.tensor([2, 3, 0, 1], dtype=torch.int32, device=h100)

    def calls():
        lm.prefill_into_slot(qp, cfg, toks[:16], cache, 0, slot=0, valid=16,
                             dtype=torch.float32)
        lm.decode_step(qp, cfg, tok, cache, lens, active=active,
                       dtype=torch.float32)
        snap = lm.verify_snapshot(cfg, cache, lens, chunk=C)
        _, _, traj = lm.verify_chunk(qp, cfg, vt, cache, lens, valids=valids,
                                     with_traj=True, dtype=torch.float32)
        lm.commit_verify(cfg, snap, cache, traj, lens, counts, valids,
                         chunk=C)

    calls()  # build, load and set up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        calls()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for layer in cache["layers"]:
        for t in layer.values():
            assert bool(torch.isfinite(t.float()).all())


@pytest.mark.gpu
@pytest.mark.parametrize("arch,kind", [("recurrentgemma-9b", "rglru"),
                                       ("xlstm-350m", "mlstm"),
                                       ("xlstm-350m", "slstm")])
def test_recurrent_blocks_at_full_width_on_card_are_finite(h100, arch, kind):
    """One full-width W8A8 block of each recurrent kind (RG-LRU with its
    GeGLU MLP, mLSTM, sLSTM) as the engine calls it, a decode step of 8
    rows (lengths 100-800) and a prefill chunk of 32 tokens at position
    100, on a cache of 1,024 positions: the output finite."""
    from repro_torch.configs import get_config
    from repro_torch.models import blocks
    from repro_torch.serving.quantize import quantize_model_params

    cfg = get_config(arch)
    gen = torch.Generator(device=h100).manual_seed(3)
    p = blocks.block_init(gen, cfg, kind, device=h100)
    qp = quantize_model_params({"layers": [p]}, cfg)["layers"][0]
    del p
    for B, C in ((8, 1), (1, 32)):
        x = torch.randn((B, C, cfg.d_model), generator=gen, device=h100)
        cache = blocks.block_init_cache(cfg, kind, B, 1024, device=h100)
        if C == 1:
            lengths = 100 * torch.arange(1, B + 1, dtype=torch.int32,
                                         device=h100)
            out = blocks.block_apply_step(qp, x, cache, lengths, cfg,
                                          kind)[0]
        else:
            pos = 100 + torch.arange(C, device=h100)[None]
            out = blocks.block_apply_chunk(qp, x, cache, cfg, kind,
                                           positions=pos)[0]
        assert bool(torch.isfinite(out).all()), (B, C)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-350m"])
def test_hybrid_engine_on_card_runs_every_kernel(h100, arch):
    """A reduced hybrid config's W8A8 engine on the card, stacked plain
    and with chain speculation (drafts forced from the plain run's
    streams, so some are accepted and some rejected), a prompt longer
    than ``max_seq``: every quantized linear goes through the MP kernel,
    every sliding-window decode through the contiguous decode kernel
    (none on xlstm), no paged kernel runs, and every request gets its
    tokens."""
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.speculative import SpecConfig

    cfg, qp = _hybrid_w8a8(arch, h100)
    mp_per_call = near_tie.mp_per_call
    n_local = sum(cfg.block_kind(li) == "local_attn"
                  for li in range(cfg.n_layers))
    plain = None
    for spec in (None, SpecConfig(k=3)):
        eng = ServeEngine(cfg, qp, batch_slots=2, max_seq=64, eos_id=-1,
                          act_dtype=torch.float32, chunk_size=16, spec=spec)
        assert eng.kv_layout == "stacked" and eng.seq_ceiling is None
        if spec is not None:
            eng.proposer = ForcedDrafts(3, plain, cfg.vocab_size)
        for n in (5, 30, 80):
            eng.submit(([3, 4, 5] * n)[:n], max_new=6)
        ops.reset_launch_counts()
        done = eng.run()
        s, n = eng.stats(), ops.launch_counts()
        assert len(done) == 3 and all(len(r.out) == 6 for r in done)
        assert n["mp_matmul"] == mp_per_call(cfg) * s["model_calls"]
        verifies = s.get("spec_ticks", 0)
        decodes = s["model_calls"] - s["prefill_calls"] - verifies
        assert n["mha_decode"] == n_local * decodes
        assert (n["paged_mha_decode"] == n["paged_verify"]
                == n["paged_verify_tree"] == 0)
        if spec is None:
            plain = {r.rid: r.out for r in done}
        else:
            assert verifies > 0
            assert 0 < s["spec_accepted"] < s["spec_proposed"]


@pytest.mark.gpu
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kvdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,lengths", [
    (1500, [1500] * 6 + [1499, 17]),  # whisper's cross cache
    (448, [68, 75, 83, 96, 88, 88, 1, 448])])  # its self cache
def test_mha_decode_at_whisper_shapes_on_card(h100, qdtype, kvdtype, S,
                                              lengths):
    """``whisper-large-v3``'s decode attention: 8 rows of 20 query heads
    over 20 KV heads of 64, over the 1,500-key cross cache (93 whole
    16-key tiles and a ragged one; every served row's length is 1,500)
    and the 448-position self cache.  Each output vector within 1e-2 of
    its plain version's largest magnitude, two calls bit-identical, one
    launch counted per call."""
    rng = np.random.default_rng(S + len(qdtype) + len(kvdtype))
    q, k, v, lens = _mha_case(rng, h100, lengths, 20, 1, 64, S, qdtype,
                              kvdtype)
    ops.reset_launch_counts()
    got = ops.mha_decode(q, k, v, lens)
    again = ops.mha_decode(q, k, v, lens)
    want = ref.mha_decode_ref(q, k, v, lens)
    torch.cuda.synchronize()
    assert _rel_err(got, want) <= ATTN_REL_TOL
    assert torch.equal(got, again)
    assert ops.launch_counts()["mha_decode"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("M,out_dtype", [
    (8, "float32"), (1500, "float32"), (3000, "float32"), (12007, "float32"),
    (12000, "float32"), (8, "bfloat16"), (32, "bfloat16"), (40, "bfloat16"),
    (3000, "bfloat16"), (12007, "bfloat16")])
@pytest.mark.parametrize("K,N", [(1280, 1280), (1280, 5120), (5120, 1280)])
def test_mp_matmul_bitexact_at_whisper_shapes_on_card(h100, K, N, M,
                                                      out_dtype):
    """The W8A8 kernel at whisper's weight shapes and the encoder's token
    counts: one request's 1,500 frames (24 blocks of 64 tokens, the last
    ragged), two requests', eight and eight with a ragged 7, and a decode
    step's 8 rows, with bias, float32 out; a decode step's, a prefill
    chunk's, a chain verify's and the encoder's two and eight and a
    ragged 7 with bf16 out: bit-identical, twice."""
    rng = np.random.default_rng(M + K + N + 3)
    args = _mp_case(rng, M, K, N, True, h100)
    dt = getattr(torch, out_dtype)
    got = ops.quant_matmul(*args, out_dtype=dt)
    again = ops.quant_matmul(*args, out_dtype=dt)
    want = ref.quant_matmul_ref(*args, out_dtype=dt)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, again)


@pytest.mark.gpu
def test_whisper_model_level_on_card_runs_the_kernels(h100):
    """Reduced ``whisper-large-v3`` W8A8 at model level on the card
    (``near_tie.whisper_run``: ragged prompts through ``lm.prefill``,
    uniform ones through ``lm.batch_prefill``, then greedy
    ``decode_step(enc_lengths=)``): every quantized linear through the MP
    kernel, two contiguous decodes a layer a step (self and cross), no
    paged kernel; the stream held to the CPU's (taught the same stream)
    under the near-tie rule."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.models.layers import to_device
    from repro_torch.serving.quantize import (calibrate,
                                              quantize_model_params)

    cfg = get_config("whisper-large-v3").reduced()
    rng = np.random.default_rng(23)
    params = lm.init(cfg, torch.Generator().manual_seed(0), max_seq=64)
    frames = rng.standard_normal((4, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    qp = quantize_model_params(params, cfg, calibrate(
        params, cfg, [rng.integers(1, cfg.vocab_size, (2, 16))],
        extras={"frames": frames[:2]}))
    ragged = [[5, 6, 7], [8, 9, 10, 11, 12, 13, 14]]
    uniform = [[3, 4, 5, 6, 7], [9, 8, 7, 6, 5]]
    ops.reset_launch_counts()
    toks, la, _ = near_tie.whisper_run(to_device(qp, h100), cfg,
                                       torch.from_numpy(frames).to(h100),
                                       ragged, uniform, 8, h100, max_seq=64)
    n = ops.launch_counts()
    assert n["mp_matmul"] == near_tie.whisper_mp_calls(cfg, 7, 8)
    assert n["mha_decode"] == 2 * cfg.n_layers * (7 + 8)
    assert n["paged_mha_decode"] == n["paged_verify"] == 0
    _, lb, _ = near_tie.whisper_run(qp, cfg, torch.from_numpy(frames),
                                    ragged, uniform, 8, torch.device("cpu"),
                                    forced=toks, max_seq=64)
    assert near_tie.hold_taught("reduced whisper card vs CPU", toks, la,
                                lb) > 0


@pytest.mark.gpu
def test_replay_engine_on_card_runs_only_decode_kernels(h100):
    """Reduced GPT-2's W8A8 engine with replay prefill on the card, paged
    and stacked: every prompt token is a decode step, so the runs launch
    the MP kernel and the paged (or contiguous) decode kernel at every
    model call and no verify; each request gets its tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.quantize import (calibrate,
                                              quantize_model_params)

    cfg = get_config("gpt2-345m").reduced()
    params = lm.init(cfg, torch.Generator().manual_seed(0), max_seq=64)
    qp = quantize_model_params(params, cfg, calibrate(
        params, cfg, [np.random.default_rng(0).integers(1, 512, (2, 16))]))
    L = cfg.n_layers
    for layout, kernel in (("paged", "paged_mha_decode"),
                           ("stacked", "mha_decode")):
        eng = ServeEngine(cfg, qp, batch_slots=2, max_seq=64, eos_id=-1,
                          act_dtype=torch.float32, chunk_size=16,
                          kv_layout=layout, prefill_mode="replay")
        for p in ([3, 4, 5], list(range(1, 40))):
            eng.submit(p, max_new=6)
        ops.reset_launch_counts()
        done = eng.run()
        s, n = eng.stats(), ops.launch_counts()
        assert len(done) == 2 and all(len(r.out) == 6 for r in done)
        assert s["prefill_calls"] == 0 and s["model_calls"] == s["ticks"]
        assert n["mp_matmul"] == 6 * L * s["model_calls"]
        assert n[kernel] == L * s["model_calls"]
        assert n["paged_verify"] == n["paged_verify_tree"] == 0


# ---------------------------------------------------------------------------
# the per-kind paged layout of a mixed stack: its attn layers' group of 16
# query heads over one KV head of 256 (recurrentgemma-9b's widths)


@pytest.mark.gpu
@pytest.mark.parametrize("n_pg,qdtype", [(40, "float32"), (40, "bfloat16"),
                                         (256, "float32")])
def test_paged_mha_decode_group_16_d256_on_card(h100, n_pg, qdtype):
    """The paged decode at 16 query heads over one KV head of 256 (two
    head chunks of 8 a block): rows of lengths 0, 1, 16, at key-split
    edges +-1 and at the end of the table, in a table of 40 pages and in
    the mixed stack's of 256 (4,096 positions).  Each output vector within
    1e-2 of its largest magnitude, the empty row exactly 0, two calls
    bit-identical, one launch counted a call."""
    rng = np.random.default_rng([1616, n_pg])
    Hkv, group, D, ps = 1, 16, 256, 16
    lengths_np = _decode_split_lengths(Hkv * group, Hkv, ps, D, n_pg)
    q, kp, vp, lengths, bt = _decode_case(rng, h100, lengths_np, Hkv, group,
                                          D, ps, n_pg, qdtype)
    ops.reset_launch_counts()
    got = ops.paged_mha_decode(q, kp, vp, lengths, bt)
    again = ops.paged_mha_decode(q, kp, vp, lengths, bt)
    want = ref.paged_mha_decode_ref(q, kp, vp, lengths, bt)
    torch.cuda.synchronize()
    assert bool((got[0] == 0).all())
    assert _rel_err(got[1:], want[1:]) <= ATTN_REL_TOL
    assert torch.equal(got, again)
    assert ops.launch_counts()["paged_mha_decode"] == 2


@pytest.mark.gpu
@pytest.mark.parametrize("n_pg,C,qdtype", [
    (24, C, qdtype) for C in (5, 32) for qdtype in ("float32", "bfloat16")]
    + [(256, 5, "float32"), (256, 32, "float32")])
def test_paged_verify_group_16_d256_on_card(h100, n_pg, C, qdtype):
    """The causal verify at 16 query heads over one KV head of 256: one
    query a 16-row tile, C tiles along the chunk, Q staged in shared
    memory and P V over two blocks; a chain verify (C 5) and a prefill
    chunk (C 32) on rows ending on a key-split edge, past it, a page past
    it, at base 0, at the end of the table and parked, in a table of 24
    pages and in the mixed stack's of 256.  Each vector within 1e-2, two
    calls bit-identical, a lower-triangular mask bit-identical to the
    causal kernel."""
    rng = np.random.default_rng([1600 + C, n_pg])
    Hkv, group, D, ps = 1, 16, 256, 16
    base_np = _split_edge_bases(C, Hkv, group, ps, n_pg)
    B = len(base_np)
    q, kp, vp, base, bt = _verify_case(rng, h100, B, C, Hkv, group, base_np,
                                       qdtype, D=D, n_pg=n_pg)
    got = ops.paged_verify(q, kp, vp, base, bt)
    again = ops.paged_verify(q, kp, vp, base, bt)
    want = ref.paged_verify_ref(q, kp, vp, base, bt)
    torch.cuda.synchronize()
    assert _rel_err(got[:-1], want[:-1]) <= ATTN_REL_TOL
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    tril = torch.tril(torch.ones((B, C, C), dtype=torch.int32, device=h100))
    assert torch.equal(ops.paged_verify(q, kp, vp, base, bt, anc=tril), got)


@pytest.mark.gpu
def test_mixed_paged_engine_on_card_matches_stacked(h100):
    """A reduced mixed stack (global attention, local attention, RG-LRU)
    as W8A8 engines on the card, on the per-kind paged layout (the auto
    layout) and on the stacked one, plain and with chain speculation on
    forced drafts: the paged runs launch the paged decode and verify for
    the attn layer and the contiguous decode for the ring, the stacked
    runs no paged kernel; each pair of streams is equal up to where it
    parts, each parting a near-tie along the calls that served it
    (``near_tie.hold_streams``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.quantize import (calibrate,
                                              quantize_model_params)
    from repro_torch.serving.speculative import SpecConfig

    cfg = dataclasses.replace(get_config("recurrentgemma-9b").reduced(),
                              name="hybrid-mixed-reduced",
                              block_pattern=("attn", "local_attn", "rglru"))
    params = lm.init(cfg, torch.Generator(device=h100).manual_seed(0),
                     device=h100)
    calib = [np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 16))]
    qp = quantize_model_params(params, cfg, calibrate(params, cfg, calib))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (5, 40,
                                                                     20)]
    shape = dict(max_seq=64, page=16, chunk=16, rows=2)
    streams, fns, plain = {}, {}, None
    for variant in ("plain", "chain"):
        for layout in ("auto", "stacked"):
            spec = SpecConfig(k=3) if variant == "chain" else None
            eng = ServeEngine(cfg, qp, batch_slots=2, max_seq=64, eos_id=-1,
                              act_dtype=torch.float32, chunk_size=16,
                              page_size=16, spec=spec, kv_layout=layout)
            assert eng.paged == (layout == "auto")
            if spec is not None:
                eng.proposer = ForcedDrafts(3, plain, cfg.vocab_size)
            for p in prompts:
                eng.submit(p, max_new=8)
            ops.reset_launch_counts()
            with near_tie.ScheduleProbe(eng) as probe:
                done = {r.rid: r.out for r in eng.run()}
            n, s = ops.launch_counts(), eng.stats()
            assert len(done) == 3 and all(len(o) == 8 for o in done.values())
            verifies = s.get("spec_ticks", 0)
            decodes = s["model_calls"] - s["prefill_calls"] - verifies
            if eng.paged:
                assert n["paged_verify"] == s["prefill_calls"] + verifies
                assert n["paged_mha_decode"] == n["mha_decode"] == decodes
            else:
                assert n["paged_verify"] == n["paged_mha_decode"] == 0
                assert n["mha_decode"] == 2 * decodes
            key = f"{'paged' if eng.paged else 'stacked'} {variant}"
            streams[key] = done
            fns[key] = near_tie.served_logits(
                qp, cfg, probe.calls, h100,
                layout="paged" if eng.paged else "stacked", **shape)
            if key == "paged plain":
                plain = done
    for a, b in (("stacked plain", "paged plain"),
                 ("paged chain", "paged plain"),
                 ("stacked chain", "paged chain")):
        near_tie.hold_streams(f"{a} vs {b}", (streams[a], streams[b]),
                              prompts, (fns[a], fns[b]), 8)


# ---------------------------------------------------------------------------
# training and checkpoints on the card


def _train_state(arch, dev, seed=0):
    from repro_torch.configs import get_config
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.trainer import TrainConfig, init_train_state

    cfg = get_config(arch).reduced()
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=1,
                                       total_steps=10))
    gen = torch.Generator(device=dev).manual_seed(seed)
    return cfg, tcfg, init_train_state(cfg, tcfg, gen, max_seq=64,
                                       device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,dtype,loss_rtol,gnorm_rtol", [
    ("gpt2-345m", "bfloat16", 1e-2, 2e-2),
    ("olmoe-1b-7b", "float32", 1e-4, 1e-4)])
def test_train_step_on_card_matches_cpu(h100, monkeypatch, arch, dtype,
                                        loss_rtol, gnorm_rtol):
    """One reduced train step from the same state on the card and on the
    CPU: the loss and the global grad norm.  GPT-2 at the
    bf16 default, whose products round differently on the two devices
    (1% on the loss, 2% on the norm).  The MoE stack at float32 (TF32
    off), 1e-4: at bf16 those roundings flip expert choices at routing
    near-ties between the devices, as they do between the port and the
    reference on the CPU."""
    import functools

    from repro_torch.core.tree import tree_map
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.training.trainer import (batch_to_tensors,
                                              make_train_step)

    monkeypatch.setattr(lm, "_forward", functools.partial(
        lm._forward, dtype=getattr(torch, dtype)))
    cfg, tcfg, state = _train_state(arch, h100)
    cpu_state = tree_map(lambda t: t.to("cpu", copy=True), state)
    batch = SyntheticLM(cfg.vocab_size, 16, 4, seed=2).batch_at(0)
    step = make_train_step(cfg, tcfg)
    _, mc = step(state, batch_to_tensors(batch, h100))
    _, mp = step(cpu_state, batch_to_tensors(batch, "cpu"))
    for key, tol in (("loss", loss_rtol), ("grad_norm", gnorm_rtol)):
        a, b = float(mc[key]), float(mp[key])
        assert np.isfinite(a) and abs(a - b) <= tol * abs(b), (key, a, b)


@pytest.mark.gpu
def test_checkpoint_round_trip_of_card_state(h100, tmp_path):
    """bf16, float32 and int32 state on the card, saved and restored to
    the card and to the CPU, bit-identical."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.tree import tree_leaves, tree_map

    _, _, state = _train_state("gpt2-345m", h100)
    tree = {"state": state,
            "bf16": tree_map(lambda t: t.to(torch.bfloat16), state.params)}
    m = CheckpointManager(str(tmp_path))
    m.save(1, tree)
    like = tree_map(lambda t: torch.empty_like(t, device="meta"), tree)
    for dev in (h100, torch.device("cpu")):
        got = m.restore(1, like, device=dev)
        for a, b in zip(tree_leaves(got), tree_leaves(tree)):
            assert a.device.type == dev.type and a.dtype == b.dtype
            assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.gpu
def test_async_save_of_card_state_isolated_from_later_steps(h100, tmp_path):
    """An async save of the card's train state, then two steps that
    update it in place: the checkpoint holds the state at the save."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.training.trainer import (batch_to_tensors,
                                              init_train_state_abstract,
                                              make_train_step)

    cfg, tcfg, state = _train_state("gpt2-345m", h100)
    step = make_train_step(cfg, tcfg)
    data = SyntheticLM(cfg.vocab_size, 16, 4, seed=3)
    state, _ = step(state, batch_to_tensors(data.batch_at(0), h100))
    want = tree_map(torch.clone, state)
    m = CheckpointManager(str(tmp_path))
    m.save(1, state, blocking=False)
    for i in (1, 2):
        state, _ = step(state, batch_to_tensors(data.batch_at(i), h100))
    m.wait()
    got = m.restore(1, init_train_state_abstract(cfg, tcfg, max_seq=64),
                    device=h100)
    assert not torch.equal(tree_leaves(state)[0], tree_leaves(want)[0])
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# multi-device serving on shards of the card (a mesh naming it several times)


#: the ring test's sizes: small ones, and GPT-2's serving ones (the
#: distributed tick's logits blocks of a shard's 4 rows, one and k + 1
#: positions each, a 2^20-float all-reduce, a decode tick's and a prefill
#: chunk's products, every W8A8 weight shape with its bias, float32 and
#: bf16 out)
_RING_SIZES = {
    "small": dict(blocks=[(3, 7, 50)], psum=4096, mm=[(8, 256, 512)],
                  tp=[(1024, 4096)], bias=False, out=["float32"]),
    "serving": dict(blocks=[(4, 50257), (4, 5, 50257)], psum=1 << 20,
                    mm=[(8, 1024, 4096), (32, 4096, 1024)],
                    tp=[(1024, 1024), (1024, 4096), (4096, 1024)], bias=True,
                    out=["float32", "bfloat16"])}


@pytest.mark.gpu
@pytest.mark.parametrize("size", list(_RING_SIZES))
def test_ring_collectives_on_four_shards_of_the_card(h100, size):
    """The ring all-gather bit-identical to ``torch.cat``, the int8-wire
    all-reduce within one int8 step per hop of the CPU's, the ring
    products within 1e-5 relative of one float32 product, and the
    column-split W8A8 product bit-identical to the unsharded kernel at M
    8, 32 and 40, one launch a shard (``_RING_SIZES``)."""
    from repro_torch.core import collectives, ring
    from repro_torch.launch.mesh import make_host_mesh

    sz = _RING_SIZES[size]
    n = 4
    mesh = make_host_mesh(model=n, devices=[h100] * n)
    rng = np.random.default_rng(41)
    for shape in sz["blocks"]:
        blocks = [torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(h100) for _ in range(n)]
        for out in collectives.ring_all_gather(blocks):
            assert torch.equal(out, torch.cat(blocks))
    xs = [rng.standard_normal(sz["psum"]).astype(np.float32)
          for _ in range(n)]
    got = collectives.compressed_psum(
        [torch.from_numpy(x).to(h100) for x in xs])
    cpu = collectives.compressed_psum([torch.from_numpy(x) for x in xs])[0]
    step = np.abs(np.stack(xs)).sum(axis=0).max() / 127.0
    assert max((g.cpu() - cpu).abs().max().item() for g in got) <= n * step
    for M, K, N in sz["mm"]:
        x = torch.from_numpy(rng.standard_normal((M, K)).astype(
            np.float32)).to(h100)
        w = torch.from_numpy(rng.standard_normal((K, N)).astype(
            np.float32)).to(h100)
        want = x @ w
        for fn, dim in ((ring.ring_ag_matmul, 1), (ring.ring_rs_matmul, 0)):
            y = torch.cat(fn(list(x.chunk(n, dim=1)),
                             [c.contiguous() for c in w.chunk(n, dim=dim)]),
                          1)
            assert (y - want).abs().max() <= 1e-5 * want.abs().max()
    for M in (8, 32, 40):
        for K, N in sz["tp"]:
            args = _mp_case(rng, M, K, N, sz["bias"], h100)
            for out_dtype in sz["out"]:
                dt = getattr(torch, out_dtype)
                ops.reset_launch_counts()
                got = ring.tp_quant_matmul(*args, mesh=mesh, out_dtype=dt)
                assert ops.launch_counts()["mp_matmul"] == n
                assert torch.equal(got, ops.quant_matmul(*args,
                                                         out_dtype=dt))


@pytest.mark.gpu
def test_distributed_engine_on_card_2x2(h100):
    """A reduced W8A8 ``DistributedServeEngine`` on 2 shards x 2 slots of
    the card against the single-device engine with 4 slots on the card:
    the streams held under the near-tie rule (``serving/near_tie.py``)
    along each run's own calls; every paged kernel launched; then
    ``ServeEngine(mesh=)`` over 4 shards of the card, whose streams are
    the unsharded engine's token for token."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh, make_serving_mesh
    from repro_torch.models import lm
    from repro_torch.serving.distributed import DistributedServeEngine
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.quantize import calibrate, quantize_model_params

    cfg = get_config("gpt2-345m").reduced()
    params = lm.init(cfg, torch.Generator().manual_seed(0), max_seq=128)
    rng = np.random.default_rng(5)
    qp = quantize_model_params(params, cfg, calibrate(
        params, cfg, [rng.integers(1, cfg.vocab_size, (2, 32))]))
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (3, 17, 33, 60, 9, 25)]
    kw = dict(max_seq=128, eos_id=-1, act_dtype=torch.float32,
              chunk_size=16, page_size=16)
    dist = DistributedServeEngine(
        cfg, qp, mesh=make_serving_mesh(2, [h100] * 2), slots_per_shard=2,
        **kw)
    single = ServeEngine(cfg, qp, batch_slots=4, device=h100, **kw)
    streams, fns = [], []
    for eng, probe, rows in ((dist, near_tie.DistScheduleProbe, 2),
                             (single, near_tie.ScheduleProbe, 4)):
        for p in prompts:
            eng.submit(p, max_new=16)
        ops.reset_launch_counts()
        with probe(eng) as pr:
            streams.append({r.rid: r.out for r in eng.run()})
        launches = ops.launch_counts()
        for k in ("mp_matmul", "paged_mha_decode", "paged_verify"):
            assert launches[k] > 0, (k, launches)
        fns.append(near_tie.served_logits(eng.params, cfg, pr.calls, h100,
                                          rows=rows))
    near_tie.hold_streams("distributed 2x2 vs single-device on the card",
                          streams, prompts, fns, 16)
    assert dist.stats()["overlap_ratio"] >= 0.5
    mesh = make_host_mesh(model=4, devices=[h100] * 4)
    ringed = ServeEngine(cfg, qp, batch_slots=4, device=h100, mesh=mesh,
                         **kw)
    for p in prompts:
        ringed.submit(p, max_new=16)
    assert {r.rid: r.out for r in ringed.run()} == streams[1]


# ---------------------------------------------------------------------------
# the analysis layer: samplers on a CUDA generator, profiler ranges


@pytest.mark.gpu
def test_samplers_on_a_cuda_generator(h100):
    """``greedy``, ``temperature`` at 0.01 and ``top_k`` at 1 give the
    argmax on the card; two draws from one seed are equal, by
    ``temperature`` at 1 and by ``top_k`` at 40."""
    from repro_torch.serving import sampler

    logits = torch.randn((8, 50257), device=h100,
                         generator=torch.Generator(device=h100).manual_seed(0))
    arg = logits.argmax(-1).to(torch.int32)
    gen = torch.Generator(device=h100).manual_seed(1)
    assert torch.equal(sampler.greedy(logits), arg)
    assert torch.equal(sampler.temperature(logits, gen, temp=0.01), arg)
    assert torch.equal(sampler.top_k(logits, gen, k=1), arg)
    a, b = (sampler.temperature(
        logits, torch.Generator(device=h100).manual_seed(2), temp=1.0)
        for _ in range(2))
    assert a.device == h100 and torch.equal(a, b)
    a, b = (sampler.top_k(logits, torch.Generator(device=h100).manual_seed(
        9), k=40, temp=1.0) for _ in range(2))
    assert torch.equal(a, b)


#: the engine's annotated dispatch sites, and the CUDA function each kernel
#: of the paged W8A8 path launches once a call (the decode's split kernel
#: is its Paged instance; the combines are not counted)
_ANNOTATED = ("prefill.chunk", "decode.step", "spec.verify", "prefill.round",
              "wave.consume", "wave.dispatch")
_RANGE_KERNELS = {"mp_matmul": ("mp_matmul_kernel",),
                  "paged_verify": ("verify::split_kernel",),
                  "paged_mha_decode": ("decode::split_kernel", "Paged")}


@pytest.mark.gpu
def test_annotated_ranges_hold_the_engine_kernels(h100):
    """A reduced W8A8 engine traced with ``annotate=True`` under
    ``torch.profiler``: the host trace valid, one range per annotated
    host span, every ``mp_matmul``, ``paged_verify`` and paged decode CUDA
    function launched inside one (as many as the counters say), none
    outside: ``mp_matmul`` inside both the prefill chunks and the decode
    steps, the verify inside the prefill chunks alone and the decode
    inside the decode steps alone; and the streams of an untraced run."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.telemetry import (Telemetry, profile_ranges,
                                               validate_chrome_trace)
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config("gpt2-345m").reduced()
    params = lm.init(cfg, torch.Generator(device=h100).manual_seed(0),
                     max_seq=64, device=h100)
    calib = [np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 16))]
    base = ServeEngine(cfg, params, batch_slots=2, max_seq=64, eos_id=-1,
                       quantized=True, calibration_batches=calib,
                       chunk_size=16)
    prompts = [list(range(1, n + 1)) for n in (5, 30, 12)]
    for p in prompts:
        base.submit(p, max_new=4)
    want = {r.rid: r.out for r in base.run()}
    eng = ServeEngine(cfg, base.params, batch_slots=2, max_seq=64,
                      eos_id=-1, act_dtype=torch.float32, chunk_size=16,
                      telemetry=Telemetry(trace=True, annotate=True))
    for p in prompts:
        eng.submit(p, max_new=4)
    ops.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = {r.rid: r.out for r in eng.run()}
        torch.cuda.synchronize()
    launches = ops.launch_counts()
    assert got == want
    host = eng.tel.tracer.to_chrome()
    validate_chrome_trace(host)
    spans = {}
    for ev in host["traceEvents"]:
        if ev["ph"] == "X" and ev["name"] in _ANNOTATED:
            spans[ev["name"]] = spans.get(ev["name"], 0) + 1
    ranges = profile_ranges(prof.profiler.kineto_results.events(),
                            _ANNOTATED)
    assert spans and {n: r["ranges"] for n, r in ranges.items()
                      if n is not None and r["ranges"]} == spans
    inside = {}
    for name, keys in _RANGE_KERNELS.items():
        inside[name] = {n: sum(c for k, c in r["kernels"].items()
                               if all(x in k for x in keys))
                        for n, r in ranges.items()}
        assert inside[name].pop(None) == 0, name
        assert sum(inside[name].values()) == launches[name] > 0, name
    mp = inside["mp_matmul"]
    assert mp["prefill.chunk"] > 0 and mp["decode.step"] > 0
    assert inside["paged_verify"]["prefill.chunk"] == launches["paged_verify"]
    assert (inside["paged_mha_decode"]["decode.step"]
            == launches["paged_mha_decode"])


@pytest.mark.gpu
@pytest.mark.parametrize("arch,shape", [
    ("gpt2-345m", "train_4k"), ("gpt2-345m", "prefill_32k"),
    ("gpt2-345m", "decode_32k"), ("llama3-8b", "decode_32k")])
def test_dry_run_cells_on_meta_beside_the_card(h100, tmp_path, arch, shape):
    """The dry run's ``run_cell`` on ``meta`` tensors on the single
    production mesh, under the PyTorch of the card's machine: ``ok``."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    rec = dryrun.run_cell(arch, shape, make_production_mesh(), "pod16x16",
                          str(tmp_path), force=True)
    assert rec["status"] == "ok", rec.get("error")


def _innermost(ranges, t):
    """The name of the innermost ``(start, end, name)`` range holding
    ``t`` (ranges nest: one thread), or None."""
    holding = [r for r in ranges if t is not None and r[0] <= t <= r[1]]
    return max(holding, key=lambda r: r[0])[2] if holding else None


@pytest.mark.gpu
def test_spans_lie_on_the_profiler_clock_on_card(h100):
    """With CUDA activities recorded, a range's ``start_ns()`` is the Unix
    epoch's clock (``time.time_ns()``), and a span's start, moved to it
    through the tracer's anchor, lies within 100 us of its range's start
    (median of 20 spans after a warm-up)."""
    import statistics
    import time

    from repro_torch.serving.telemetry import Tracer
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tr = Tracer(annotate=True)
    x = torch.ones(1 << 16, device=h100)
    before = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with tr.span("warm-up"):
            x.add_(1)
        for i in range(20):
            before[f"probe{i}"] = (time.time_ns(), time.monotonic_ns())
            with tr.span(f"probe{i}"):
                x.add_(1)
            torch.cuda.synchronize()
    starts = {e.name(): e.start_ns()
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU
              and e.is_user_annotation() and e.name().startswith("probe")}
    spans = {e[1]: e[4] for e in tr.events if e[1].startswith("probe")}
    assert len(starts) == len(spans) == 20
    epoch = [starts[n] - before[n][0] for n in starts]
    mono = [starts[n] - before[n][1] for n in starts]
    gaps = [abs(spans[n] - starts[n]) for n in starts]
    print(f"range start after time.time_ns(): median "
          f"{statistics.median(epoch) / 1e3:.1f} us; after "
          f"time.monotonic_ns(): {statistics.median(mono) / 1e9:.1f} s; "
          f"span start from range start: median "
          f"{statistics.median(gaps) / 1e3:.1f} us, most "
          f"{max(gaps) / 1e3:.1f} us")
    assert 0 <= statistics.median(epoch) <= 1_000_000
    assert statistics.median(gaps) <= 100_000


@pytest.mark.gpu
def test_engine_syncs_are_the_sync_debug_modes_on_card(h100):
    """A reduced W8A8 engine traced with ``annotate=True`` under
    ``torch.profiler`` and ``torch.cuda.set_sync_debug_mode("warn")``:
    in every tick the synchronizing calls the debug mode reports are the
    ``engine.sync`` spans, each range launches exactly one copy, and a
    tick of one decode step alone waits 9 times.  The stage ranges hold
    no ``mp_matmul`` launch as innermost range but ``model.attn`` (the
    attention's projections) and none of the paged kernels' but
    ``model.attn``."""
    import warnings

    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.telemetry import Telemetry
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = get_config("gpt2-345m").reduced()
    params = lm.init(cfg, torch.Generator(device=h100).manual_seed(0),
                     max_seq=64, device=h100)
    calib = [np.random.default_rng(0).integers(1, cfg.vocab_size, (2, 16))]
    qparams = ServeEngine(cfg, params, batch_slots=2, max_seq=64,
                          quantized=True, calibration_batches=calib,
                          chunk_size=16).params
    eng = ServeEngine(cfg, qparams, batch_slots=2, max_seq=64, eos_id=-1,
                      act_dtype=torch.float32, chunk_size=16,
                      telemetry=Telemetry(trace=True, annotate=True))
    for n in (5, 30, 12):
        eng.submit(list(range(1, n + 1)), max_new=6)
    eng.tick()  # the first tick builds and warms what it launches
    torch.cuda.synchronize()
    tr = eng.tel.tracer
    warned, spans, alone = [], [], []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("warn")
        try:
            while eng.queue or any(s is not None for s in eng.slots):
                tr.reset()
                with warnings.catch_warnings(record=True) as w:
                    warnings.simplefilter("always")
                    eng.tick()
                warned.append(sum("synchroniz" in str(x.message)
                                  for x in w))
                names = [e[1] for e in tr.events if e[0] == "X"]
                spans.append(names.count("engine.sync"))
                alone.append(names.count("decode.step") == 1
                             and "prefill.chunk" not in names)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert warned == spans and sum(spans) > 0
    assert {s for s, a in zip(spans, alone) if a} == {9}
    evs = list(prof.profiler.kineto_results.events())
    ann = [(e.start_ns(), e.end_ns(), e.name()) for e in evs
           if e.device_type() == DeviceType.CPU and e.is_user_annotation()]
    calls = {e.correlation_id(): e.start_ns() for e in evs
             if e.device_type() == DeviceType.CPU
             and not e.is_user_annotation() and e.name().startswith("cu")}
    owner = [(e.name(), _innermost(ann, calls.get(e.correlation_id())))
             for e in evs if e.device_type() != DeviceType.CPU
             and not e.is_user_annotation()]
    synced = [n for n, o in owner if o == "engine.sync"]
    assert len(synced) == sum(spans)
    assert all(n.startswith("Memcpy") for n in synced), set(synced)
    kernels = {o for n, o in owner if "mp_matmul_kernel" in n
               or "split_kernel" in n or "combine_kernel" in n}
    assert not {o for o in kernels if o and o.startswith(("model.",
                                                          "engine."))} \
        - {"model.attn"}
