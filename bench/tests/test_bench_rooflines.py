"""Each roofline file's operations and bytes against hand counts."""
import pytest

import bench_tiny
from harness import peaks, spec

RF = bench_tiny.ROOT / "bench" / "rooflines"


def mod(name):
    return spec.load_module(RF / f"{name}.py")


def test_mp_matmul():
    c = mod("mp_matmul").cost(2, 3, 4, out_bytes=4, bias=True)
    assert c["ops"] == {"int8": 48.0}
    # w 12, x 6, x_scale 8, w_scale 16, y 32, bias 16
    assert c["bytes"] == 90.0


def test_paged_mha_decode():
    c = mod("paged_mha_decode").cost([3, 1], 2, 1, 4, 2, q_bytes=4,
                                     kv_bytes=2)
    assert c["ops"] == {"fp32": 4 * 2 * 4 * 4.0}
    # K and V of 4 keys, 2 table rows of 2 pages, 2 lengths, q and out
    assert c["bytes"] == 64 + 16 + 8 + 128


def test_paged_verify():
    c = mod("paged_verify").cost(2, 2, 1, 1, 2, 1)
    # query 0 sees keys 0..2, query 1 keys 0..3: 7 pairs
    assert c["ops"] == {"bf16": 4 * 1 * 2 * 7.0}
    assert c["bytes"] == 32 + 4 + 4 + 32


def test_moe_ffn():
    c = mod("moe_ffn").cost(2, 2, 3, 4, 1, gated=True)
    assert c["ops"] == {"fp32": 72.0 + 32.0}
    # 2 touched experts x 3 banks of 2 x 3, router, tokens in and out,
    # router logits
    assert c["bytes"] == 4.0 * (36 + 8 + 8 + 8)


def test_decoder_step_sums_its_parts():
    model = {"d_model": 4, "n_layers": 2, "vocab_size": 10, "n_heads": 2,
             "n_kv_heads": 2, "head_dim": 2, "d_ff": 8, "n_experts": 0,
             "activation": "gelu_mlp", "pos": "learned",
             "tie_embeddings": True}
    call = {"kind": "decode", "rows": 2, "lengths": [3, 0]}
    got = mod("decoder_step").cost(model, call, max_seq=16, page_size=4)
    mp, att = mod("mp_matmul"), mod("paged_mha_decode")
    lin = [mp.cost(2, 4, 4)] * 4 + [mp.cost(2, 4, 8), mp.cost(2, 8, 4)]
    a = att.cost([4, 1], 2, 2, 2, 4)
    ops = 2 * (sum(x["ops"]["int8"] for x in lin))
    assert got["ops"]["int8"] == ops
    assert got["ops"]["fp32"] == 2 * a["ops"]["fp32"] + 2.0 * 2 * 4 * 10
    head = 4.0 * (10 * 4 + 2 * 4 + 2 * 10)
    assert got["bytes"] == pytest.approx(
        2 * (sum(x["bytes"] for x in lin) + a["bytes"]) + head
        + 4.0 * 4 * 4)
    b = mod("decoder_step").bound_s(model, call, max_seq=16, page_size=4)
    assert b == peaks.bound_s(got["ops"], got["bytes"])
