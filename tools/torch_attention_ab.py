"""Times kernels B1, B2 and B3 at the serve shapes, for the checkout given,
so two versions of the kernels can be compared on one card in one call.

    python tools/torch_attention_ab.py [ROOT]

ROOT is a checkout of this repo (default: the one holding this script).
The script builds ROOT's kernels (into ROOT/build/kernels), then prints one
JSON line per shape. For B1 and B3: the max abs error of B1 and of B3
(4 shards) against ``flash_attention_plain``, and the CUDA-event ms of B1,
B3 and ``scaled_dot_product_attention`` on the same bf16 inputs. For B2, at
the scan drive's shard shapes: one hop over a query shard strided across
the batch with a non-trivial incoming state, its max abs error in acc / l
against ``ring_flash_hop_plain``, and its ms. Times are taken as
``chip_smoke.py`` takes its kernels'. To compare two trees, unpack one
under the git-ignored ``build/`` and run them in turns (a, b, b, a) in one
command. Needs one NVIDIA GPU.
"""

from __future__ import annotations

import json
import os
import sys

SHAPES = [(2, 4096, 8, 40), (2, 1024, 8, 80), (2, 1024, 8, 64),
          (2, 1024, 8, 160)]
# B2: (B, L, S, H, D) of a query shard and a K/V shard of a 4-shard ring
HOP_SHAPES = [(2, 1024, 1024, 8, 40), (2, 256, 256, 8, 80)]


def main(argv: list[str]) -> int:
    root = os.path.abspath(argv[0] if argv else
                           os.path.dirname(os.path.dirname(__file__)))
    os.chdir(root)
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    import chip_smoke
    from chiaswarm_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_plain,
    )
    from chiaswarm_tpu_torch.ops.kernels import build_all
    from chiaswarm_tpu_torch.ops.ring_flash_attention import (
        ring_flash_fused,
        ring_flash_hop,
        ring_flash_hop_plain,
    )

    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    build_all()
    gen = torch.Generator().manual_seed(0)
    for b, l, h, d in SHAPES:
        q, k, v = (torch.randn((b, l, h, d), generator=gen)
                   .to("cuda", torch.bfloat16) for _ in range(3))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ref = flash_attention_plain(q, k, v).float()

        def err(out):
            return (out.float() - ref).abs().max().item()

        print(json.dumps({
            "tree": root, "shape": [b, l, h, d],
            "device": torch.cuda.get_device_name(0),
            "b1_err": err(flash_attention(q, k, v)),
            "b3_err": err(ring_flash_fused(q, k, v, shards=4)),
            "b1_ms": chip_smoke.time_ms(
                torch, lambda: flash_attention(q, k, v), iters=40),
            "b3_ms": chip_smoke.time_ms(
                torch, lambda: ring_flash_fused(q, k, v, shards=4), iters=40),
            "sdpa_ms": chip_smoke.time_ms(
                torch, lambda: F.scaled_dot_product_attention(qt, kt, vt),
                iters=40),
        }), flush=True)
    for b, l, s, h, d in HOP_SHAPES:
        q = torch.randn((b, 4 * l, h, d), generator=gen).to(
            "cuda", torch.bfloat16)[:, l:2 * l]
        k0, v0, k, v = (torch.randn((b, s, h, d), generator=gen)
                        .to("cuda", torch.bfloat16) for _ in range(4))
        state = ring_flash_hop_plain(
            q, k0, v0, torch.full((b, h, l), -1e30, device="cuda"),
            torch.zeros((b, h, l), device="cuda"),
            torch.zeros((b, l, h, d), device="cuda"), scale=d ** -0.5)
        ref_m, ref_l, ref_acc = ring_flash_hop_plain(q, k, v, *state,
                                                     scale=d ** -0.5)
        m, lsum, acc = (t.clone() for t in state)
        ring_flash_hop(q, k, v, m, lsum, acc)
        err = (acc / lsum.transpose(1, 2)[..., None]
               - ref_acc / ref_l.transpose(1, 2)[..., None]).abs().max().item()
        print(json.dumps({
            "tree": root, "hop_shape": [b, l, s, h, d],
            "device": torch.cuda.get_device_name(0), "b2_err": err,
            "b2_ms": chip_smoke.time_ms(
                torch, lambda: ring_flash_hop(q, k, v, m, lsum, acc),
                iters=40),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
