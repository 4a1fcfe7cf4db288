"""LM serving launcher:  python -m repro_torch.launch.serve --arch <id>
[--device cuda|cpu] [options].

The twin of ``python -m repro.launch.serve`` (the same flags, plus
``--device``): spins up the continuous-batching engine on a reduced or
full config with seeded random weights and runs a synthetic request
stream, reporting tokens/s.  Runs on ``--device`` (default ``cuda``: the
CUDA kernels; ``cpu``: their plain versions).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCHS, applicable_shapes, get_config, get_reduced
from repro_torch.models import init_params
from repro_torch.serve import ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--paged", action="store_true",
                    help="Hilbert-paged KV cache instead of the dense (B, S) cache")
    ap.add_argument("--attn", choices=("flash", "xla"), default="flash",
                    help="paged decode attention: the CUDA kernel or the plain page gather")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--page-layout", choices=("hilbert", "naive"), default="hilbert")
    ap.add_argument("--prefill-chunk", type=int, default=8)
    ap.add_argument("--prefill", choices=("chunked", "compiled"), default="chunked",
                    help="admission prefill: chunked masked decode steps, or one batched "
                    "forward per cohort (requires --paged)")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="copy-on-write Hilbert-page prefix sharing across requests "
                    "(requires --paged)")
    ap.add_argument("--hilbert-admission", action="store_true",
                    help="order each admitted cohort by Hilbert token rank")
    ap.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = ap.parse_args(argv)

    if "decode_32k" not in applicable_shapes(args.arch):
        raise SystemExit(f"{args.arch} is encoder-only: no decode path")

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    params = init_params(0, cfg, device=args.device)
    engine = ServeEngine(cfg, params, num_slots=args.slots,
                         max_len=args.max_len, temperature=args.temperature,
                         paged=args.paged, attn_impl=args.attn,
                         page_size=args.page_size, page_layout=args.page_layout,
                         prefill_chunk=args.prefill_chunk,
                         prefill=args.prefill,
                         prefix_sharing=args.prefix_sharing,
                         hilbert_admission=args.hilbert_admission)

    rng = np.random.default_rng(0)
    # a shared system-prompt prefix so --prefix-sharing has pages to hit
    shared = rng.integers(0, cfg.vocab_size, size=args.page_size + 4).tolist()
    reqs = []
    for _ in range(args.requests):
        plen = int(rng.integers(1, 8))
        prompt = rng.integers(0, cfg.vocab_size, size=plen).tolist()
        if args.prefix_sharing:
            prompt = shared + prompt
        reqs.append(engine.submit(prompt, max_new=args.max_new))

    t0 = time.perf_counter()
    engine.run_until_done()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in reqs)
    print(f"{args.arch}: served {len(reqs)} requests, {toks} tokens "
          f"in {dt:.1f}s ({toks/dt:.1f} tok/s, {args.slots} slots, {args.device})")
    if args.paged:
        kv = engine.kv_pages
        print(f"  pages: allocated={kv.stat_allocated} "
              f"shared={kv.stat_shared} cow={kv.stat_cow}")
    for r in reqs[:3]:
        print(f"  req{r.rid}: {r.prompt} -> {r.out}")


if __name__ == "__main__":
    main()
