"""Recipe: jit-save a causal LM, serve it through the inference API, and
batch-generate with beam search and sampling: the counterpart of
``examples/llm_serve.py`` (static-graph export -> predictor; the
reference's roles: AnalysisPredictor and PaddleNLP ``generate``).

    python -m paddle_tpu_torch.examples.llm_serve              # on the card
    python -m paddle_tpu_torch.examples.llm_serve --smoke --device cpu

Steps, on a small Llama (head_dim 128, as the flash kernel takes; its
draft has head_dim 64):
  1. ``jit.save`` it (``.pdiparams``, ``.pdmodel`` and the exported
     ``.pt2`` program) and run the artifact through ``inference.Config``
     / ``create_predictor``, the loader a fresh serving process uses;
  2. batched beam search (4 beams, length penalty 0.6, eos 2) and
     sampling (top-p 0.9, temperature 0.8, seed 0) on the live model:
     ``generate()``'s static-cache route, one program per signature (a
     CUDA graph on the card);
  3. ``LLMPredictor`` with weight-only int8 projections;
  4. greedy ``SpeculativePredictor`` with a 1-layer, quarter-width draft.

``--smoke`` generates fewer tokens. ``main`` returns the step results so
that other scripts can drive it.
"""
from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import numpy as np
import torch

from ..framework import resolve_device
from ..models import LlamaConfig, LlamaForCausalLM


def _model(cfg, dev, seed):
    return LlamaForCausalLM(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed)).eval()


def main(argv=None):
    from .. import jit
    from ..inference import (Config, LLMPredictor, SpeculativePredictor,
                             create_predictor)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="fewer new tokens: a quick check")
    ap.add_argument("--beams", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    max_new = args.max_new or (8 if args.smoke else 16)
    # Llama's tiny config at head_dim 128
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                           num_key_value_heads=2, tensor_parallel=False)
    model = _model(cfg, dev, 0)
    res = {}

    # -- 1) exported artifact -> predictor --------------------------------
    workdir = tempfile.mkdtemp(prefix="llm_serve_")
    try:
        path = os.path.join(workdir, "llama")
        jit.save(model, path, input_spec=[jit.InputSpec([1, 16], "int64",
                                                        "input_ids")])
        print(f"saved the exported program: {path}.pt2")
        pred_cfg = Config(path + ".pdmodel")
        if dev.type == "cpu":
            pred_cfg.disable_gpu()
        predictor = create_predictor(pred_cfg)
        prompt = np.random.RandomState(0).randint(1, cfg.vocab_size, (1, 16))
        names = predictor.get_input_names()
        predictor.get_input_handle(names[0]).copy_from_cpu(prompt)
        predictor.run()
        logits = predictor.get_output_handle(
            predictor.get_output_names()[0]).copy_to_cpu()
        with torch.no_grad():
            live = model(torch.as_tensor(prompt, device=dev)).float().cpu()
        err = float(np.abs(logits.astype(np.float32) - live.numpy()).max())
        print(f"predictor logits: {logits.shape}, max_abs_err vs the live "
              f"model {err:.3e}")
        res["predictor_err"] = err
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # -- 2) batched generation --------------------------------------------
    prompts = np.random.RandomState(1).randint(1, cfg.vocab_size, (4, 12))
    beam_out, beam_scores = model.generate(
        prompts, max_new_tokens=max_new, decode_strategy="beam_search",
        num_beams=args.beams, length_penalty=0.6, eos_token_id=2)
    print(f"beam_search[{args.beams}]: {tuple(beam_out.shape)} "
          f"scores={np.round(beam_scores.numpy(), 2)}")
    sample_out, _ = model.generate(
        prompts, max_new_tokens=max_new, decode_strategy="sampling",
        top_p=0.9, temperature=0.8, seed=0)
    print(f"sampling: {tuple(sample_out.shape)}")
    res.update(beam=beam_out, beam_scores=beam_scores, sampled=sample_out)

    # -- 3) weight-only int8 serving ----------------------------------------
    pred8 = LLMPredictor(_model(cfg, dev, 0), quant_type="weight_only_int8",
                         eos_token_id=2)
    toks = pred8.generate([[5, 9, 23], [7, 11, 9, 14]], max_new_tokens=8)
    print(f"weight-only int8 predictor: {[len(t) for t in toks]}")
    res["int8"] = toks

    # -- 4) speculative decoding with a 1-layer, quarter-width draft ------
    draft = _model(LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size // 4,
        intermediate_size=cfg.intermediate_size // 4, num_hidden_layers=1,
        num_attention_heads=max(cfg.num_attention_heads // 4, 1),
        num_key_value_heads=max(cfg.num_key_value_heads // 4, 1),
        max_position_embeddings=cfg.max_position_embeddings,
        tensor_parallel=False), dev, 1)
    spec = SpeculativePredictor(model, draft, gamma=4)
    out = spec.generate([5, 9, 23, 7], max_new_tokens=12)
    st = spec.stats
    print(f"speculative decode: {len(out)} tokens in {st['target_calls']} "
          f"target calls (accept rate "
          f"{st['accepted'] / max(st['proposed'], 1):.2f})")
    res["speculative"] = out
    print("OK")
    return res


if __name__ == "__main__":
    main()
