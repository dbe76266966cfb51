"""Multi-device serving on the PyTorch port: the paper's distributed
architecture, driven by one controller over a list of devices.

    PYTHONPATH=src python examples/multi_node_ring_torch.py              # the card
    PYTHONPATH=src python examples/multi_node_ring_torch.py --device cpu

Two acts (the JAX example's second and third; its first, an HLO profile
of the ring, has no PyTorch counterpart):

  1. **Ring-TP serving**: ``ServeEngine(mesh=...)`` routes every linear
     through the ring schedule over 4 shards; the tokens equal the
     unsharded engine's.
  2. **Distributed serving**: ``DistributedServeEngine`` keeps one page
     pool per shard; only block-table rows, tokens and logits travel,
     and the pipelined tick stages every transfer behind compute
     (overlap ratio and per-shard utilization printed); greedy tokens
     equal the single-device engine's.

With fewer cards than shards the mesh names one card several times (on
one card, ``["cuda:0"] * 4``): every hop is then a copy on that card.
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import (make_host_mesh,  # noqa: E402
                                     make_serving_mesh)
from repro_torch.models import lm  # noqa: E402
from repro_torch.serving.distributed import (  # noqa: E402
    DistributedServeEngine)
from repro_torch.serving.engine import ServeEngine, resolve_device  # noqa

SHARDS = 4


def shard_devices(device: torch.device, n: int):
    """``n`` entries: the visible cards in turn, or the CPU ``n`` times."""
    if device.type == "cpu":
        return ["cpu"] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args()
    device = resolve_device(args.device)
    devices = shard_devices(device, SHARDS)

    cfg = get_config("gpt2-345m").reduced()  # d 64, vocab 512
    params = lm.init(cfg, torch.Generator().manual_seed(0), max_seq=64)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
               for n in (5, 24, 9, 33, 7, 18)]
    calib = [rng.integers(1, cfg.vocab_size, (2, 32))]
    common = dict(max_seq=64, eos_id=-1, chunk_size=8, quantized=True,
                  calibration_batches=calib)

    def serve(eng):
        for p in prompts:
            eng.submit(p, max_new=6)
        return {tuple(r.prompt): r.out for r in eng.run()}

    print(f"1. ring-TP serving over {SHARDS} shards "
          f"({', '.join(str(d) for d in devices)})")
    plain = serve(ServeEngine(cfg, params, batch_slots=2, device=device,
                              **common))
    mesh = make_host_mesh(model=SHARDS, devices=devices)
    ringed = serve(ServeEngine(cfg, params, batch_slots=2, device=device,
                               mesh=mesh, **common))
    print(f"   ring-TP tokens identical: {ringed == plain}\n")
    assert ringed == plain

    print(f"2. distributed serving: {SHARDS} KV-pool shards, one slot each")
    eng = DistributedServeEngine(cfg, params,
                                 mesh=make_serving_mesh(SHARDS, devices),
                                 slots_per_shard=1, **common)
    dist = serve(eng)
    s = eng.stats()
    print(f"   greedy tokens identical to single device: {dist == plain}")
    print(f"   ticks={s['ticks']} model_calls={s['model_calls']} "
          f"prefix_hit_pages={s.get('prefix_hit_pages', 0)}")
    print(f"   per-shard utilization: "
          f"{np.round(eng.utilization(), 2).tolist()}")
    print(f"   transfers: {s['transfers']} ({s['transfers_hidden']} hidden "
          f"behind compute, overlap_ratio={s['overlap_ratio']:.2f}; "
          f"drain {s.get('overlap_ratio_drain', 1.0):.2f})")
    print(f"   largest transfer: {s['max_transfer_bytes']} B (block tables, "
          "tokens, lengths, logits: K/V pages never move)")
    assert dist == plain


if __name__ == "__main__":
    main()
