"""Serve a small model on the PyTorch/CUDA port with batched,
continuously-batched requests.

The twin of ``examples/serve_lm.py``, at its sizes: requests of different
lengths join and leave decode slots mid-flight; per-slot positions and
slot-masked cache updates keep them isolated (checked at the end against
a solo run), and the paged engine with compiled prefill and prefix
sharing decodes token-identically to the dense engine.  Parameters are
seeded random weights (``init_params(seed, cfg)``).  Runs on the card
unless ``--device cpu``; exits non-zero when a check fails.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py [--arch tinyllama-1.1b] [--device cpu]
"""
import argparse
import sys

from repro_torch.configs import get_reduced
from repro_torch.models import init_params
from repro_torch.serve import ServeEngine


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prefill", choices=("chunked", "compiled"), default="compiled",
                    help="prefill mode for the paged engine pass")
    ap.add_argument("--prefix-sharing", action="store_true", default=True,
                    help="COW prefix sharing for the paged engine pass")
    ap.add_argument("--no-prefix-sharing", dest="prefix_sharing", action="store_false")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    cfg = get_reduced(args.arch, dtype="float32")
    params = init_params(0, cfg, device=args.device)
    print(f"serving reduced {args.arch}: {cfg.num_layers}L d={cfg.d_model} "
          f"{args.slots} slots on {args.device}")

    engine = ServeEngine(cfg, params, num_slots=args.slots, max_len=128)
    prompts = [[11, 29, 3], [101, 7], [42, 42, 42, 42], [5], [77, 1, 9], [250, 16]]
    reqs = [engine.submit(p, max_new=8) for p in prompts]
    engine.run_until_done()
    for r in reqs:
        print(f"req{r.rid}: prompt={r.prompt} -> {r.out}")

    # isolation check vs solo decoding
    solo = ServeEngine(cfg, params, num_slots=1, max_len=128)
    r0 = solo.submit(prompts[0], max_new=8)
    solo.run_until_done()
    isolated = r0.out == reqs[0].out
    print(f"continuous-batching isolation (solo == batched): {isolated}")

    # paged engine with compiled prefill + COW prefix sharing: shared-prefix
    # prompts must decode token-identically to the dense engine.  2 slots /
    # 3 requests staggers admission so the third request's prefix is
    # already in the trie; the 20-token shared prefix ends mid-page (ps=8),
    # so the divergent tail lands in a shared page and copies it on write.
    paged = ServeEngine(cfg, params, num_slots=2, max_len=128, paged=True, attn_impl="xla",
                        page_size=8, prefill=args.prefill, prefix_sharing=args.prefix_sharing)
    shared = [11, 29, 3, 101, 7] * 4  # 20 tokens
    pp = [shared + [101, 7, 55] * 5, shared + [42, 42, 9] * 5, shared + [5, 5, 5] * 5]
    preqs = [paged.submit(p, max_new=8) for p in pp]
    paged.run_until_done()

    dense = ServeEngine(cfg, params, num_slots=args.slots, max_len=128)
    dreqs = [dense.submit(p, max_new=8) for p in pp]
    dense.run_until_done()
    identical = all(pr.out == dr.out for pr, dr in zip(preqs, dreqs))
    kv = paged.kv_pages
    print(f"paged prefill={args.prefill} sharing={args.prefix_sharing}: "
          f"allocated={kv.stat_allocated} shared={kv.stat_shared} cow={kv.stat_cow} -- "
          f"dense-identical: {identical}")
    fired = kv.stat_shared > 0 if args.prefix_sharing else True
    if args.prefix_sharing:
        print(f"prefix sharing fired: {fired}")
    return 0 if isolated and identical and fired else 1


if __name__ == "__main__":
    sys.exit(main())
