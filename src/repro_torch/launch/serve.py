"""Serving launcher: uniform-batch prefill + decode, or with
``--continuous`` a mixed-length request stream through the continuous
batcher, with the compressed serving plane (port of
`repro.launch.serve`).

``--kv-bits`` switches the KV cache to packed codes + group scales and
``--stages N`` routes the hidden state through N-1 delta-coded hops
per token (`repro_torch.serving.delta`).  ``--continuous`` serves 2 x
``--batch`` requests, prompts of 4 to ``--prompt-len`` tokens drawn as
the JAX launcher draws them (``numpy.random.default_rng(1)``), each
generating ``--gen`` tokens, over ``--slots`` cache slots
(`repro_torch.serving.batcher`).  The comm flags and ``--comm-config``
JSON are those of the JAX package, and the resolved config is echoed
back as JSON; ``--list-wires`` prints the wire registry.  Sharded
serving (``--data-par``/``--model-par`` above 1) is refused with the
title of the ROADMAP item that ports it.  ``--continuous`` takes every
family, as JAX's: its requests carry no frames or patches (an audio
pool's cross caches stay zero, a vlm model serves text only), and a
vlm pool still holds ``num_patches`` more rows.  The stage groups
follow the JAX package's rule: ``--stages`` divides the layers (a MoE
model's past its dense prefix), or a hybrid's blocks.
The weights and the prompt are a random init from ``--seed``, drawn
on the CPU and moved to the device leaf by leaf, so a seed gives the
same model on the card and on the CPU; so are an audio model's stub
frames (B, encoder_seq, d) and a vlm model's stub patches (B,
num_patches, d), N(0, 0.02) as the JAX launcher draws them (its
threefry stream is not reproduced), which the timed prefill takes (the
encoder runs inside it); a vlm cache holds ``num_patches`` more rows;
sampling noise (``--temperature``) comes from a generator on the device
(`repro_torch.rng`).  ``--arch`` defaults to ``gemma2-9b``, as in the
JAX launcher.

Runs on CUDA unless ``--device cpu`` asks for the CPU; with no card and
no such request it raises.

Examples, full width and depth, on one card: the paper's 1.5B model,
  python -m repro_torch.launch.serve --arch gpt2-xl-paper --stages 2 \\
      --mode aqsgd --fw-bits 4 --kv-bits 8 --batch 8 --prompt-len 128 \\
      --gen 32
and gemma2-9b (9.24B parameters, 37 GB at f32; a prompt past its
4096-key window, into a cache of its 8192-token context):
  python -m repro_torch.launch.serve --arch gemma2-9b --stages 2 \\
      --mode aqsgd --fw-bits 4 --kv-bits 8 --batch 2 --prompt-len 8160 \\
      --gen 32
stablelm-12b (12.1B parameters, 48.6 GB at f32; its untied head and
head_dim 160) over a cache of 4096 tokens:
  python -m repro_torch.launch.serve --arch stablelm-12b --stages 2 \\
      --mode aqsgd --fw-bits 4 --kv-bits 8 --batch 2 --prompt-len 4064 \\
      --gen 32
gemma2-27b at full width, cut to the first 28 of its 46 layers
(``--layers``: the whole model, 109 GB at f32, does not fit an 80 GB
card):
  python -m repro_torch.launch.serve --arch gemma2-27b --layers 28 \\
      --stages 2 --mode aqsgd --fw-bits 4 --kv-bits 8 --batch 2 \\
      --prompt-len 8160 --gen 32
mamba2-1.3b (the ssm family: 1.34B parameters; no KV cache, so
``--kv-bits`` passes through, and a state of 805 MB + 20 MB at batch 8
whatever the prompt's length):
  python -m repro_torch.launch.serve --arch mamba2-1.3b --stages 2 \\
      --mode aqsgd --fw-bits 4 --kv-bits 8 --batch 8 --prompt-len 2048 \\
      --gen 32
zamba2-2.7b (the hybrid family: 54 mamba layers in 9 blocks, each
followed by one shared attention block of head_dim 80, 2.34B
parameters; its stage groups cut the blocks, so ``--stages`` 1, 3 or
9; its shared block keeps raw k and v, so ``--kv-bits`` 0):
  python -m repro_torch.launch.serve --arch zamba2-2.7b --stages 3 \\
      --mode aqsgd --fw-bits 4 --batch 2 --prompt-len 4064 --gen 32
the moe family at full width, depth cut (``--layers`` counts the dense
prefix; the stage groups cut the MoE layers after it): deepseek-moe-16b
(64 experts top-6, 2 shared, the first layer dense; 5 of its 28 layers,
2.65B parameters) over a cache of 4096 tokens, and mixtral-8x22b (8
experts top-2, a 4096-token window, untied head; 2 of its 56 layers,
5.41B parameters) over 8192; the launcher prints the total and active
parameters, and the KV bytes a token, the prefix's raw:
  python -m repro_torch.launch.serve --arch deepseek-moe-16b --layers 5 \\
      --stages 2 --mode aqsgd --fw-bits 4 --kv-bits 8 --batch 2 \\
      --prompt-len 4064 --gen 32
  python -m repro_torch.launch.serve --arch mixtral-8x22b --layers 2 \\
      --stages 2 --mode aqsgd --fw-bits 4 --kv-bits 8 --batch 2 \\
      --prompt-len 8160 --gen 32
whisper-small (the audio family: 12 encoder layers over 1500 frames
and 12 decoder layers with cross attention, 2.4e8 parameters; the cross
caches stay raw beside the 8-bit self-attention KV):
  python -m repro_torch.launch.serve --arch whisper-small --stages 2 \\
      --mode aqsgd --fw-bits 4 --kv-bits 8 --batch 8 --prompt-len 128 \\
      --gen 32
pixtral-12b at full width (the vlm family: 1024 patch rows ahead of the
text, GQA 32:8, head_dim 128, untied head), cut to 4 of its 40 layers,
a trunk of 4064 rows in a cache of 4096:
  python -m repro_torch.launch.serve --arch pixtral-12b --layers 4 \\
      --stages 2 --mode aqsgd --fw-bits 4 --kv-bits 8 --batch 2 \\
      --prompt-len 3040 --gen 32
and a stream of 16 mixed-length requests over 8 slots of gpt2-xl:
  python -m repro_torch.launch.serve --arch gpt2-xl-paper --stages 2 \\
      --mode aqsgd --fw-bits 4 --kv-bits 8 --continuous --slots 8 \\
      --batch 8 --prompt-len 128 --gen 32
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.comm import config as comm_cli
from repro_torch.configs.base import ARCHS, get_config
from repro_torch.models.model import Transformer, stage_size
from repro_torch.rng import seeded_generator
from repro_torch.serving import ContinuousBatcher, DeltaHopCodec, KVCodec

# flags of the JAX launcher the port refuses above 1, and the title of
# the ROADMAP item that ports them
NOT_PORTED = {
    "data_par": 'sharded serving (ROADMAP queue A, "The rest of the '
                'distributed work")',
    "model_par": 'sharded serving (ROADMAP queue A, "The rest of the '
                 'distributed work")',
}


def resolve_device(name: str) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for the CPU; never a silent move to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "(device='cpu') to run on the CPU")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="gemma2-9b", choices=list(ARCHS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="serve only the first N layers of the arch at "
                         "its full width (0: all of them), for a model "
                         "whose full depth does not fit the card")
    comm_cli.add_cli_args(ap)
    ap.add_argument("--list-wires", action="store_true",
                    help="print the wire registry table and exit")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--stages", type=int, default=1,
                    help="pipeline stage groups for decode; >1 routes "
                         "the hidden state through delta-coded hops")
    ap.add_argument("--continuous", action="store_true",
                    help="serve a mixed-length request stream through "
                         "the continuous batcher instead of one "
                         "uniform batch")
    ap.add_argument("--slots", type=int, default=0,
                    help="batcher cache slots (default: --batch)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompt tokens")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "PyTorch codec)")
    return ap


def serve(args) -> dict:
    """Run prefill + ``args.gen`` decode steps; returns the timings (the
    model build's, ``build_s``, too), the generated tokens, the last
    logits, the KV stores' device bytes (``kv_store_bytes`` over
    ``cache_len`` token rows) and the ssm and hybrid families' state
    bytes (``state_bytes``: the ``ssm`` states and ``conv`` windows)."""
    dev = resolve_device(args.device)
    comm = comm_cli.from_args(args)
    print("comm:", comm.to_json())
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.layers:
        if not 0 < args.layers <= cfg.num_layers:
            raise ValueError(f"--layers {args.layers}: {cfg.name} has "
                             f"{cfg.num_layers}")
        cfg = cfg.with_(num_layers=args.layers)
    stage_size(cfg, args.stages)
    kv_codec = KVCodec.from_comm(comm)
    hop = DeltaHopCodec.from_comm(comm) if args.stages > 1 else None
    if hop is not None:
        print(f"decode hop [{comm.mode}]: "
              f"{hop.hop_bytes(args.batch, cfg.d_model)} B/token/boundary "
              f"x {args.stages - 1} boundaries "
              f"(fp32 {args.batch * cfg.d_model * 4} B)")
    if kv_codec.bits and cfg.is_attention_free:
        print(f"kv cache: none ({cfg.family} family: {kv_codec.bits}-bit "
              f"kv passes through)")
    elif kv_codec.bits:
        row = (1, 1, cfg.num_kv_heads, cfg.head_dim)
        raw_tok = 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * 4
        # the dense prefix's raw stores: f32 caches, or the batcher's
        # bf16 pool
        raw = "bf16" if args.continuous else "f32"
        prefix_tok = raw_tok // cfg.num_layers * cfg.first_dense_layers \
            // (2 if args.continuous else 1)
        per_tok = kv_codec.stored_bytes(row) * 2 * cfg.n_trunk + prefix_tok
        print(f"kv cache: {per_tok} B/token stored "
              f"({kv_codec.bits}-bit; raw f32 {raw_tok} B)"
              + (f", the dense prefix's {prefix_tok} B raw {raw}"
                 if prefix_tok else ""))
    if cfg.has_moe:
        print(f"params: {cfg.params_count()} total, "
              f"{cfg.active_params_count()} active a token "
              f"({cfg.n_experts} experts top-{cfg.top_k}, "
              f"{cfg.n_shared_experts} shared)")

    _sync(dev)
    tb = time.perf_counter()
    gen = torch.Generator().manual_seed(args.seed)
    model = Transformer(cfg, device=dev, generator=gen)
    _sync(dev)
    build_s = time.perf_counter() - tb
    print(f"model build: {build_s:.3f}s")
    cache_len = args.prompt_len + args.gen + cfg.num_patches
    if args.continuous:
        out = serve_continuous(args, model, dev, cache_len, kv_codec, hop)
        out["build_s"] = build_s
        return out
    caches = model.init_caches(args.batch, cache_len, torch.float32,
                               kv_codec=kv_codec)
    if hop is not None:
        caches["hop_m"] = hop.init_state(args.stages - 1, args.batch,
                                         cfg.d_model, device=dev)["m"]
    tokens = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen).to(dev)
    extras = stub_inputs(cfg, args.batch, gen, dev)
    noise = seeded_generator(dev, args.seed, "noise")
    kvc = kv_codec if kv_codec.bits else None
    bfn_p = hop.boundary_fn(prefill=True) if hop is not None else None
    bfn_d = hop.boundary_fn(prefill=False) if hop is not None else None

    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = model.forward_with_caches(
        tokens, caches, logits_last_only=True, num_stages=args.stages,
        boundary_fn=bfn_p, kv_codec=kvc, **extras)
    _sync(dev)
    t1 = time.perf_counter()
    del extras
    print(f"prefill {args.batch}x{args.prompt_len}: {t1 - t0:.3f}s")

    out_tokens = []
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    for _ in range(args.gen):
        out_tokens.append(tok)
        logits, caches = model.forward_with_caches(
            tok, caches, logits_last_only=True, num_stages=args.stages,
            boundary_fn=bfn_d, kv_codec=kvc)
        if args.temperature > 0:
            probs = torch.softmax(logits[:, -1] / args.temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=noise)
        else:
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    _sync(dev)
    t2 = time.perf_counter()
    generated = torch.cat(out_tokens, dim=1)
    tok_s = args.gen * args.batch / (t2 - t1)
    print(f"decode {args.gen} tokens: {t2 - t1:.3f}s ({tok_s:.1f} tok/s)")
    print("sample token ids:", generated[0][:12].tolist())
    kv_bytes, state_bytes, cross_bytes = pool_bytes(caches)
    if state_bytes:
        print(f"ssm state: {state_bytes} B ({caches['ssm'].nbytes} ssm + "
              f"{caches['conv'].nbytes} conv)")
    if cross_bytes:
        print(f"cross caches: {cross_bytes} B raw f32 ({cfg.num_layers} "
              f"layers x {cfg.encoder_seq} frames, k and v)")
    return {"build_s": build_s, "prefill_s": t1 - t0, "decode_s": t2 - t1,
            "decode_tok_s": tok_s,
            "tokens": generated, "logits": logits,
            "kv_store_bytes": kv_bytes, "state_bytes": state_bytes,
            "cross_bytes": cross_bytes, "cache_len": cache_len}


def stub_inputs(cfg, batch: int, gen: torch.Generator, dev) -> dict:
    """The stub frontends' inputs of a serving prefill, N(0, 0.02) from
    the launcher's CPU generator: an audio model's ``frames`` (B,
    encoder_seq, d), a vlm model's ``patches`` (B, num_patches, d)
    (JAX `repro.launch.serve` draws them the same way from threefry)."""
    shape = {"audio": ("frames", cfg.encoder_seq),
             "vlm": ("patches", cfg.num_patches)}.get(cfg.family)
    if shape is None:
        return {}
    return {shape[0]: (torch.randn((batch, shape[1], cfg.d_model),
                                   generator=gen) * 0.02).to(dev)}


def submit_stream(bat: ContinuousBatcher, args) -> None:
    """Submit the ``--continuous`` request stream to ``bat``: 2 x
    ``args.batch`` requests, prompts of 4 to ``args.prompt_len`` tokens,
    drawn as the JAX launcher draws them (``default_rng(1)``)."""
    rng = np.random.default_rng(1)
    for _ in range(args.batch * 2):   # oversubscribe: forces evict+admit
        plen = int(rng.integers(4, args.prompt_len + 1))
        bat.submit(rng.integers(0, bat.cfg.vocab_size, plen).tolist(),
                   max_new_tokens=args.gen)


def serve_continuous(args, model, dev, cache_len: int, kv_codec, hop):
    """The ``--continuous`` run: 2 x ``args.batch`` requests through a
    `ContinuousBatcher` of ``args.slots`` slots (default ``args.batch``).
    Returns the model, the requests, the tick and token counts, the
    wall time and its tokens a second, the prefill and decode seconds
    apart (the batcher's ``stats``) and the pool's KV store, state and
    cross-cache bytes (`pool_bytes`)."""
    slots = args.slots or args.batch
    bat = ContinuousBatcher(model, num_slots=slots, cache_len=cache_len,
                            kv_codec=kv_codec, hop_codec=hop,
                            num_stages=args.stages)
    submit_stream(bat, args)
    _sync(dev)
    t0 = time.perf_counter()
    reqs = bat.run()
    _sync(dev)
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.tokens) for r in reqs)
    print(f"continuous: {len(reqs)} requests over {slots} slots, "
          f"{n_tok} tokens in {dt:.1f}s ({n_tok / dt:.1f} tok/s)")
    for r in reqs[:4]:
        print(f"  prompt[{len(r.prompt):3d}] -> {r.tokens[:8]}")
    st = bat.stats
    # every admitted request's first token comes from its prefill
    dec_tok = n_tok - sum(1 for r in reqs if r.tokens)
    dec_tok_s = dec_tok / st["decode_s"] if st["decode_s"] else 0.0
    print(f"continuous: {st['prefills']} prefills {st['prefill_s']:.3f}s, "
          f"{st['ticks']} decode ticks {st['decode_s']:.3f}s "
          f"({dec_tok_s:.1f} tok/s)")
    kv_bytes, state_bytes, cross_bytes = pool_bytes(bat.caches)
    pool = bat.caches
    if state_bytes:
        print(f"ssm state: {state_bytes} B ({pool['ssm'].nbytes} ssm "
              f"{_dtype_name(pool['ssm'])} + {pool['conv'].nbytes} conv "
              f"{_dtype_name(pool['conv'])}, {slots} slots)")
    if cross_bytes:
        print(f"cross caches: {cross_bytes} B raw "
              f"{_dtype_name(pool['xk'])} ({model.cfg.num_layers} layers x "
              f"{model.cfg.encoder_seq} frames, k and v, {slots} slots)")
    return {"model": model, "requests": reqs, "num_slots": slots,
            "ticks": st["ticks"],
            "admissions": st["prefills"], "tokens": n_tok, "wall_s": dt,
            "tok_s": n_tok / dt, "prefill_s": st["prefill_s"],
            "decode_s": st["decode_s"], "decode_tokens": dec_tok,
            "decode_tok_s": dec_tok_s,
            "kv_store_bytes": kv_bytes, "state_bytes": state_bytes,
            "cross_bytes": cross_bytes, "cache_len": cache_len}


def pool_bytes(caches: dict) -> tuple:
    """Device bytes of a cache dict's KV stores (raw or coded, a MoE
    model's raw prefix included), its ``ssm`` states and ``conv``
    windows, and an audio model's cross caches ``xk``/``xv``."""
    return tuple(sum(caches[n].nbytes for n in names if n in caches)
                 for names in (("k", "v", "k_codes", "k_scale", "v_codes",
                                "v_scale", "pk", "pv"), ("ssm", "conv"),
                               ("xk", "xv")))


def _dtype_name(t: torch.Tensor) -> str:
    return {torch.float32: "f32", torch.bfloat16: "bf16"}.get(
        t.dtype, str(t.dtype).removeprefix("torch."))


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.list_wires:
        from repro_torch.launch.train import print_wires
        print_wires()
        return None
    for flag, what in NOT_PORTED.items():
        if getattr(args, flag) > 1:
            ap.error(f"--{flag.replace('_', '-')}: {what} is not ported "
                     f"yet")
    return serve(args)


if __name__ == "__main__":
    main()
