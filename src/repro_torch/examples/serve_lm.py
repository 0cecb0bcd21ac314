"""Batched serving example: prefill a batch of prompts, then decode new
tokens step by step against the KV cache (greedy sampling); port of
``examples/serve_lm.py``.

  PYTHONPATH=src python -m repro_torch.examples.serve_lm --arch mamba2_1_3b
  PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.examples.serve_lm")
    ap.add_argument("--arch", default="qwen1_5_0_5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a GPU) or 'cpu'")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import configs
    from repro_torch.device import resolve_device
    from repro_torch.models.model import build_model

    dev = resolve_device(args.device)
    cfg = configs.get_reduced(args.arch)
    model = build_model(cfg)
    params = model.init(0, device=dev)

    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=dev, dtype=torch.int32)
    batch = {"tokens": prompts}
    extra = torch.Generator(device=dev).manual_seed(2)
    if cfg.family == "vlm":
        batch["patches"] = torch.randn((args.batch, cfg.frontend_seq, cfg.d_model),
                                       generator=extra, device=dev)
    if cfg.family == "audio":
        batch["frames"] = torch.randn((args.batch, cfg.encoder_seq, cfg.d_model),
                                      generator=extra, device=dev)

    front = cfg.frontend_seq if cfg.family == "vlm" else 0
    s_max = args.prompt_len + front + args.new_tokens + 1
    with torch.no_grad():
        logits, state = model.prefill(params, batch, s_max=s_max)
        tok = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        generated = [tok]
        for _ in range(args.new_tokens - 1):
            logits, state = model.decode_step(params, tok, state)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            generated.append(tok)

    out = torch.stack(generated, dim=1).cpu()
    print(f"arch={cfg.name} generated {tuple(out.shape)} tokens:")
    for row in out[:2]:
        print("  ", row[:16].tolist(), "...")
    print("serving OK")
    return out


if __name__ == "__main__":
    main()
