"""How far an f32 eval forward of each vision model lies from the same
forward in f64: the model zoo of ``chip_smoke.py``'s vision phase at full
width, batch 2, weights drawn from ``--seed`` by the phase's
``zoo_gate_weights`` (BatchNorm at its initial running stats, as the
phase runs it). Per model it prints the largest
difference between the CPU's f32 forward and the CPU's f64 forward over
the largest output, and, where there is a card, the same for the card's
f32 forward (cuDNN's convolutions sum in other orders) and between the
two f32 forwards: the readings a sound forward gives. Beside them it
prints, on the card, the readings of forwards the gate must refuse: the
f32 forward with TF32 convolutions and products, the forward in bf16,
and the f32 forward with one planted fault (the first convolution
weight with a kernel wider than 1 transposed in its two spatial axes).
The phase's card-vs-CPU limit stands between the two sets. Last, on
the host: how far the planted fault and another input move the f32
output at the family's own init, which is why the gate redraws the
weights.

    python tools/vision_zoo_conditioning.py [--models alexnet vgg16]
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import paddle_tpu_torch as pt  # noqa: E402
from chip_smoke import zoo_gate_weights  # noqa: E402

ZOO = {"lenet": ("LeNet", dict(num_classes=10), (1, 28, 28)),
       "alexnet": ("alexnet", {}, (3, 224, 224)),
       "vgg16": ("vgg16", {}, (3, 224, 224)),
       "mobilenet_v1": ("mobilenet_v1", {}, (3, 224, 224)),
       "mobilenet_v2": ("mobilenet_v2", {}, (3, 224, 224)),
       "mobilenet_v3_small": ("mobilenet_v3_small", {}, (3, 224, 224)),
       "mobilenet_v3_large": ("mobilenet_v3_large", {}, (3, 224, 224)),
       "squeezenet1_1": ("squeezenet1_1", {}, (3, 224, 224)),
       "shufflenet_v2_x1_0": ("shufflenet_v2_x1_0", {}, (3, 224, 224)),
       "densenet121": ("densenet121", {}, (3, 224, 224)),
       "googlenet": ("googlenet", {}, (3, 224, 224)),
       "inception_v3": ("inception_v3", {}, (3, 299, 299))}


def plant_fault(model):
    """Transpose the spatial axes of the first convolution weight whose
    kernel is wider than 1: a layer wired wrong, its weights intact."""
    for p in model.parameters():
        if p.ndim == 4 and p.shape[-1] > 1 and p.shape[-1] == p.shape[-2]:
            with torch.no_grad():
                p.copy_(p.transpose(-1, -2).clone())
            return
    raise ValueError("no convolution with a kernel wider than 1")


def forward(name, device, dtype, x, seed, tf32=False, fault=False,
            own_init=False):
    ctor, kw, _ = ZOO[name]
    pt.seed(seed)
    model = getattr(pt.vision.models, ctor)(device=device, **kw)
    model.to(dtype=dtype).eval()
    if not own_init:
        zoo_gate_weights(torch, model, seed)
    if fault:
        plant_fault(model)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        with torch.no_grad():
            out = model(torch.from_numpy(x).to(device, dtype))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    outs = out if isinstance(out, tuple) else (out,)
    return [o.double().cpu().numpy() for o in outs]


def rel(a, b):
    return max(float(np.abs(x - y).max() / np.abs(y).max())
               for x, y in zip(a, b))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", nargs="*", default=list(ZOO))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    card = torch.cuda.is_available()
    for name in args.models:
        shape = ZOO[name][2]
        x = np.random.RandomState(args.seed).rand(2, *shape).astype(
            np.float32)
        f64 = forward(name, "cpu", torch.float64, x, args.seed)
        f32 = forward(name, "cpu", torch.float32, x, args.seed)
        line = (f"{name}: CPU f32 vs f64 {rel(f32, f64):.3e} of the largest "
                f"output ({max(np.abs(o).max() for o in f64):.3e})")
        if card:
            g32 = forward(name, "cuda", torch.float32, x, args.seed)
            tf = forward(name, "cuda", torch.float32, x, args.seed,
                         tf32=True)
            bf = forward(name, "cuda", torch.bfloat16, x, args.seed)
            bad = forward(name, "cuda", torch.float32, x, args.seed,
                          fault=True)
            line += (f"; card f32 vs CPU f64 {rel(g32, f64):.3e}; card f32 "
                     f"vs CPU f32 {rel(g32, f32):.3e}; to refuse, vs CPU "
                     f"f32: card TF32 {rel(tf, f32):.3e}, card bf16 "
                     f"{rel(bf, f32):.3e}, card f32 with a transposed "
                     f"convolution {rel(bad, f32):.3e} "
                     f"({torch.cuda.get_device_name(0)})")
        x2 = np.random.RandomState(args.seed + 1).rand(*x.shape).astype(
            np.float32)
        own = [forward(name, "cpu", torch.float32, xi, args.seed,
                       fault=fault, own_init=True)
               for xi, fault in ((x, False), (x, True), (x2, False))]
        line += (f"; at the family's own init, vs its f32 forward: the "
                 f"transposed convolution {rel(own[1], own[0]):.3e}, "
                 f"another input {rel(own[2], own[0]):.3e}")
        print(line, flush=True)


if __name__ == "__main__":
    main()
