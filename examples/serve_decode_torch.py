"""Batched serving through the PyTorch port: the prefill fills the cache,
then token-by-token greedy decode (the twin of ``examples/serve_decode.py``).

    PYTHONPATH=src python examples/serve_decode_torch.py --arch rwkv6-3b \
        --new 24

The attention runs through the flash kernel (its plain version on
``--device cpu``); ``--full`` builds the config at full width and depth
in bf16 instead of the smoke config in f32.  ``--device`` defaults to
``cuda``.
"""
import argparse
import time

import torch

from repro_torch.config import RunConfig, get_config
from repro_torch.models.convert import from_jax_params
from repro_torch.models.transformer import init_cache, init_model
from repro_torch.serve import make_prefill_cache_step, make_serve_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--full", action="store_true",
                    help="full width and depth, bf16 weights")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = get_config(args.arch, smoke=not args.full)
    dtype = "bfloat16" if args.full else "float32"
    run = RunConfig(attention_impl="flash", attention_chunk=32, remat="none",
                    param_dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = from_jax_params(cfg, init_model(cfg, gen, getattr(torch, dtype)),
                            run=run, device=dev)
    B, P = args.batch, args.prompt_len
    max_seq = P + args.new
    pgen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), dtype=torch.int32,
                            generator=pgen, device=dev)

    prefill = make_prefill_cache_step(cfg, run)
    serve = make_serve_step(cfg, run)

    cache = init_cache(cfg, B, max_seq, device=dev)
    t0 = time.perf_counter()
    logits, cache = prefill(model, prompts, cache)
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    print(f"prefill {B}x{P} in {time.perf_counter() - t0:.2f}s")

    out = [tok]
    t0 = time.perf_counter()
    for i in range(args.new - 1):
        tok, cache, _ = serve(model, cache, tok, P + i)
        out.append(tok)
    dt = time.perf_counter() - t0
    gen_tokens = torch.cat(out, dim=1)
    print(f"decoded {args.new - 1} tokens/request in {dt:.2f}s "
          f"({B * (args.new - 1) / max(dt, 1e-9):.1f} tok/s batch "
          "throughput)")
    for b in range(min(B, 2)):
        print(f"  request {b}: {gen_tokens[b].tolist()}")
    return {"model": model, "prompts": prompts, "tokens": gen_tokens,
            "cfg": cfg, "run": run}


if __name__ == "__main__":
    main()
