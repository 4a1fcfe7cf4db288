"""Hash the outputs of the flash kernels (rows 20-22) on seeded inputs.

On a machine with an NVIDIA GPU, from the root of a checkout:

    python3 tools/gqa_hashes.py

It builds the checkout's kernels, launches ``sfc_flash_decode``,
``sfc_flash_prefill`` and ``sfc_flash_attention`` on chip_smoke.py's
inputs at TinyLlama's serving shapes (GQA), in f32 and bf16, then
``sfc_flash_decode`` and ``sfc_flash_prefill`` on the latent core at MLA's
full shapes (chip_smoke.latent_inputs: g 128, D 576, f32 q) over a bf16
and an f32 pool, then ``sfc_flash_attention`` at Zamba2's D = 80
(chip_smoke.d80_inputs: B·H 64, S 2048, causal) in bf16 and f32, then
``sfc_flash_prefill`` at OLMoE's cohort (chip_smoke.mha_inputs: Hkv 16, g
1, D 128, pages of 16: 128 tokens a CTA on the wgmma and tiled cores), at
Qwen's (chip_smoke.qwen_inputs: Hkv 8, g 5, D 128: 25 tokens a CTA), at
Minitron's (chip_smoke.minitron_inputs: Hkv 8, g 4, D 128: 32 tokens a
CTA), at StableLM's (chip_smoke.stablelm_inputs: Hkv 32, g 1, D 64: 128
tokens a CTA) and at Chameleon's (chip_smoke.chameleon_inputs: Hkv 8, g 8,
D 128: 16 tokens a CTA) in f32 and bf16, and prints one JSON object of
SHA-256 prefixes of their outputs (prefill: the rows its runs cover).  It reads only the checkout
it lies in: to check that a change keeps these bits, copy it into a
``git archive`` of the parent commit and run it in both trees; the two
objects are equal when the bits are (a parent without a key, or without
the inputs of one, prints none for it).
"""
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def hashes(device) -> dict:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import launch

    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        rng = np.random.default_rng(1234)
        dec, pre, att = (cs.decode_inputs(rng, device, dtype), cs.prefill_inputs(rng, device, dtype),
                         cs.attention_inputs(rng, device, dtype))
        p_dec, p_pre, p_att = cs.flash_programs(device, dec, pre, att)
        rows = cs.prefill_covered(pre[5], pre[2].shape[1], cs.SERVE_PAGE, device)
        for name, fn in (("sfc_flash_decode", lambda: launch(p_dec, *dec)),
                         ("sfc_flash_prefill", lambda: launch(p_pre, *pre[:5])[rows]),
                         ("sfc_flash_attention", lambda: launch(p_att, *att[:3]))):
            t = fn()
            torch.cuda.synchronize()
            out[f"{name} {str(dtype)[6:]}"] = digest(t)
    scale = 1.0 / float(np.sqrt(cs.MLA_QK_WIDTH))
    for pool_dtype in (torch.bfloat16, torch.float32):
        rng = np.random.default_rng(4321)
        for prefill in (False, True):
            inp = cs.latent_inputs(rng, device, pool_dtype, prefill=prefill)
            prog = cs.latent_programs(device, inp, scale)
            t = launch(prog, *inp[:4], inp[3])
            if prefill:
                t = t[cs.prefill_covered(inp[4], inp[2].shape[1], cs.SERVE_PAGE, device)]
            torch.cuda.synchronize()
            out[f"{prog.name} latent pool {str(pool_dtype)[6:]}"] = digest(t)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = cs.d80_inputs(np.random.default_rng(80), device, dtype)
        t = launch(cs.d80_program(device, q), q, k, v)
        torch.cuda.synchronize()
        out[f"sfc_flash_attention d80 {str(dtype)[6:]}"] = digest(t)
        del q, k, v, t
    for dtype in (torch.float32, torch.bfloat16):
        (_dec, pre, _att), (_p_dec, p_pre, _p_att) = cs.mha_inputs(np.random.default_rng(35), device, dtype)
        rows = cs.prefill_covered(pre[5], pre[2].shape[1], cs.SERVE_PAGE, device)
        t = launch(p_pre, *pre[:5])[rows]
        torch.cuda.synchronize()
        out[f"sfc_flash_prefill mha {str(dtype)[6:]}"] = digest(t)
        del pre, t
    for tag, inputs, seed in (("g5", "qwen_inputs", 36), ("g4", "minitron_inputs", 38),
                              ("mha_d64", "stablelm_inputs", 38), ("g8_d128", "chameleon_inputs", 39)):
        if not hasattr(cs, inputs):
            continue
        for dtype in (torch.float32, torch.bfloat16):
            (_dec, pre, _att), (_p_dec, p_pre, _p_att) = getattr(cs, inputs)(np.random.default_rng(seed), device,
                                                                             dtype)
            rows = cs.prefill_covered(pre[5], pre[2].shape[1], cs.SERVE_PAGE, device)
            t = launch(p_pre, *pre[:5])[rows]
            torch.cuda.synchronize()
            out[f"sfc_flash_prefill {tag} {str(dtype)[6:]}"] = digest(t)
            del pre, t
    return out


def digest(t) -> str:
    import torch

    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gqa_hashes: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    print(json.dumps(hashes(torch.device("cuda", 0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
